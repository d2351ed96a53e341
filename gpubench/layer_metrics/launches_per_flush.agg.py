"""``launches_per_flush.agg``: the port's kernel launches
(``repro_torch.kernels.runtime.LAUNCHES``, all kernels) in the window over
its flushes."""


def read(ctx):
    n = ctx.get("n_flushes", 0)
    return ctx.get("launches", 0) / n if n else None
