from .lora import (DEFAULT_ALPHA, adapter_masks, apply_pair, attach_ranks,
                   count_params, init_adapters, init_pair, is_pair,
                   mask_adapters, mask_pair, merge_pair, pair_masks,
                   pair_scale, set_ranks, strip_ranks, tree_map_pairs)
from .policy import POLICIES, apply_policy, filter_specs

__all__ = [
    "DEFAULT_ALPHA", "adapter_masks", "apply_pair", "attach_ranks",
    "count_params", "init_adapters", "init_pair", "is_pair", "mask_adapters",
    "mask_pair", "merge_pair", "pair_masks", "pair_scale", "set_ranks",
    "strip_ranks", "tree_map_pairs", "POLICIES", "apply_policy",
    "filter_specs",
]
