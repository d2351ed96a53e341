"""``validate_ms.agg``: the async service's intake validation
(``fl.validate``, ``AsyncAggregator._validate_update`` whole), its mean
host duration an upload over the traced flushes, from the program's trace
recorder."""
from gpubench.lib import recorder


def read(ctx):
    s = recorder.session()
    if s is None:
        return None
    found = recorder.spans(s, "fl.validate")
    return recorder.host_s(found) / len(found) * 1e3 if found else None
