"""``packed_agg_roofline``: the least time of the traced flushes' RBLA
rounds over the device time of the grouped aggregation kernel
(``stream_kernel`` of ``csrc/rbla_agg.cu``) in the profiler's trace, in
%.  The least time is the bytes each round needs
(``gpubench/counts/packed_agg.py``, from the pair shapes and each round's
ranks) over the card's HBM bandwidth."""
from gpubench.counts import packed_agg
from gpubench.lib.trace import kernel_seconds

KERNELS = ("stream_kernel",)


def read(ctx):
    peaks, reading = ctx.get("peaks"), ctx.get("trace")
    if not peaks or not reading:
        return None
    n, seconds = kernel_seconds(reading, KERNELS)
    if not n or seconds <= 0:
        return None
    need = sum(packed_agg.round_bytes(ctx["pair_shapes"], ranks,
                                      ctx["r_max"])
               for ranks in ctx["trace_batches"])
    return 100.0 * need / peaks["hbm_bytes"] / seconds
