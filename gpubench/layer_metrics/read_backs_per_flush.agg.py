"""``read_backs_per_flush.agg``: the program's host reads of device values
(the ``read_back`` counter over its sites: ``validate``, one a float leaf
an upload; ``plan.spec``, the plan's rank reads; ``span.block``, the
spans' waits), over the traced flushes (``flush`` spans)."""
from gpubench.lib import recorder


def read(ctx):
    s = recorder.session()
    if s is None:
        return None
    flushes = len(recorder.spans(s, "flush"))
    n, _ = recorder.counted(s, "read_back")
    return n / flushes if flushes else None
