"""``read_back_wait_ms.agg``: the host ms the program waited in its reads of
device values (the ``read_back`` counter's seconds, every site) a traced
flush."""
from gpubench.lib import recorder


def read(ctx):
    s = recorder.session()
    if s is None:
        return None
    flushes = len(recorder.spans(s, "flush"))
    _, seconds = recorder.counted(s, "read_back")
    return seconds / flushes * 1e3 if flushes else None
