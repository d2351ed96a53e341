"""``plan_hit_ratio.agg``: the plan cache's hits over its lookups in the
traced flushes (the ``plan_cache`` counter, counted where the strategy's
``plan_stats`` counts), in %."""
from gpubench.lib import recorder


def read(ctx):
    s = recorder.session()
    if s is None:
        return None
    sites = s["counters"].get("plan_cache", {})
    hits = sites.get("hit", [0])[0]
    lookups = hits + sites.get("miss", [0])[0]
    return 100.0 * hits / lookups if lookups else None
