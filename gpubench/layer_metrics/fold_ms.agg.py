"""``fold_ms.agg``: the service's ``fold`` span (one a flush: the
strategy's round over the buffered uploads, to the new global on the
device), its sum over its count in the window."""


def read(ctx):
    total, n = ctx.get("spans", {}).get("fold", (0.0, 0))
    return total / n * 1e3 if n else None
