"""``peak_mem_gb.train``: ``torch.cuda.max_memory_allocated()`` over the
window (reset at its start), in GB (1e9 bytes)."""


def read(ctx):
    peak = ctx.get("peak_window_bytes", 0)
    return peak / 1e9 if peak and ctx.get("peaks") else None
