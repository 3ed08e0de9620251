"""ZeRO data parallelism and Megatron tensor parallelism on
``torch.distributed`` — the port of ``repro/sharding``: ``rules`` builds
spec trees (no process group needed), ``context`` applies them at run time
(``ShardedContext``/``TreePlan``), ``tp`` runs the model axis's operators,
and ``ctx`` keeps the reference's ambient-mesh surface and the per-layer
gather hook."""
from repro_torch.sharding import ctx, tp
from repro_torch.sharding.context import (Collectives, LayerGather,
                                          ShardedContext, TreePlan,
                                          delete_tree, tree_per_device_bytes)
from repro_torch.sharding.ctx import (constrain, constrain_spec,
                                      current_mesh, resolve_entry,
                                      set_current_mesh, use_mesh)
from repro_torch.sharding.rules import (DP_AXIS_NAMES, MODEL_AXIS,
                                        TP_COL_SITES, TP_ROW_SITES, P,
                                        ShardingStrategy, SpecMesh,
                                        adapter_pspecs, batch_pspecs,
                                        cache_pspecs, dp_axes, param_pspecs,
                                        spec_device_fraction, validate_tp,
                                        zero_opt_pspecs)
from repro_torch.sharding.tp import TensorParallel

__all__ = ["Collectives", "DP_AXIS_NAMES", "LayerGather", "MODEL_AXIS", "P",
           "ShardedContext", "ShardingStrategy", "SpecMesh", "TP_COL_SITES",
           "TP_ROW_SITES", "TensorParallel", "TreePlan", "adapter_pspecs",
           "batch_pspecs", "cache_pspecs", "constrain", "constrain_spec",
           "ctx", "current_mesh", "delete_tree", "dp_axes", "param_pspecs",
           "resolve_entry", "set_current_mesh", "spec_device_fraction",
           "tp", "tree_per_device_bytes", "use_mesh", "validate_tp",
           "zero_opt_pspecs"]
