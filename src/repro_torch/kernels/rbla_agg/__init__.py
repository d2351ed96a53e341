from .ops import packed_agg, packed_agg_inline, rbla_agg
from .ref import packed_agg_ref, rbla_agg_ref

__all__ = ["packed_agg", "packed_agg_inline", "rbla_agg", "packed_agg_ref",
           "rbla_agg_ref"]
