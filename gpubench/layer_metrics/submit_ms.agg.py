"""``submit_ms.agg``: the async service's ``submit`` span
(``obs_span_seconds{stage="submit"}``), its sum over its count in the
window: a mean per upload.  The span closes before a flushing submit
flushes, so no flush's time is in it; the count includes the flushing
submits."""


def read(ctx):
    total, n = ctx.get("spans", {}).get("submit", (0.0, 0))
    return total / n * 1e3 if n else None
