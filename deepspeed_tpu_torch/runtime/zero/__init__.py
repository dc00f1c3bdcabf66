"""ZeRO: the partition planner, the engine's sharded state, ``zero.Init``,
MiCS and the memory-needs estimators (the JAX package's ``runtime/zero``)."""

from .estimator import (estimate_zero2_model_states_mem_needs, estimate_zero2_model_states_mem_needs_all_cold,
                        estimate_zero2_model_states_mem_needs_all_live, estimate_zero3_model_states_mem_needs,
                        estimate_zero3_model_states_mem_needs_all_cold,
                        estimate_zero3_model_states_mem_needs_all_live)
from .init import Init, ShardedParams
from .mics import MiCS_Init, validate_mics_mesh
from .partition import (LeafPlan, ZeroPlan, plan_grad_specs, plan_opt_state_specs, plan_param_specs, plan_zero,
                        shard_leaf_dim, zero_axes_for)

__all__ = ["plan_param_specs", "plan_grad_specs", "plan_opt_state_specs", "plan_zero", "shard_leaf_dim",
           "zero_axes_for", "LeafPlan", "ZeroPlan", "Init", "ShardedParams", "MiCS_Init", "validate_mics_mesh",
           "estimate_zero2_model_states_mem_needs", "estimate_zero2_model_states_mem_needs_all_live",
           "estimate_zero2_model_states_mem_needs_all_cold", "estimate_zero3_model_states_mem_needs",
           "estimate_zero3_model_states_mem_needs_all_live", "estimate_zero3_model_states_mem_needs_all_cold"]
