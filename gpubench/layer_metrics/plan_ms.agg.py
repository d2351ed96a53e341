"""``plan_ms.agg``: the strategy's plan of a round (``plan``: the cohort's
spec with its rank reads, the cache lookup and a build on a miss), its
host ms a traced flush.  The rank reads wait for the stack copy before
them."""
from gpubench.lib import recorder


def read(ctx):
    s = recorder.session()
    if s is None:
        return None
    flushes = len(recorder.spans(s, "flush"))
    found = recorder.spans(s, "plan")
    return recorder.host_s(found) / flushes * 1e3 \
        if flushes and found else None
