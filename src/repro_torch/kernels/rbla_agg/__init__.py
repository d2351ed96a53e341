from .ops import (MAX_ROBUST_CLIENTS, StackPlan, StackTable, axpy_fold,
                  axpy_fold_group, flora_stack, flora_stack_group, packed_agg,
                  packed_agg_group, packed_agg_inline, packed_robust,
                  packed_robust_group, packed_stack, packed_stack_group,
                  rbla_agg, rbla_agg_group, stack_plan, stack_table)
from .ref import (axpy_fold_group_ref, axpy_fold_ref, flora_stack_group_ref,
                  flora_stack_ref, packed_agg_group_ref, packed_agg_ref,
                  packed_robust_group_ref, packed_robust_ref,
                  packed_stack_group_ref, packed_stack_ref,
                  rbla_agg_group_ref, rbla_agg_ref)

__all__ = ["packed_agg", "packed_agg_group", "packed_agg_inline", "rbla_agg",
           "rbla_agg_group", "packed_robust", "packed_robust_group",
           "packed_stack", "packed_stack_group", "StackPlan", "stack_plan",
           "flora_stack", "flora_stack_group", "axpy_fold",
           "axpy_fold_group", "StackTable", "stack_table",
           "MAX_ROBUST_CLIENTS", "packed_agg_ref", "rbla_agg_ref",
           "rbla_agg_group_ref", "packed_robust_ref", "packed_agg_group_ref",
           "packed_robust_group_ref", "packed_stack_ref",
           "packed_stack_group_ref", "flora_stack_ref",
           "flora_stack_group_ref", "axpy_fold_ref", "axpy_fold_group_ref"]
