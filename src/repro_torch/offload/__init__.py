# Phase-aware host offload: runtime device<->host swapping of RLHF role
# state (host_store + scheduler) and offload-aware remat (policies) — the
# port of repro/offload. The schedule is compiled from core.phases; byte
# movement gates on the pinned-memory probe in offload.compat.
from repro_torch.offload.host_store import (HostParkingLot, LotStats,
                                            tree_nbytes)
from repro_torch.offload.policies import (offload_remat_policy,
                                          remat_policy_for)
from repro_torch.offload.scheduler import (RUNTIME_PHASE_SEQUENCE,
                                           OffloadExecutor, OffloadPlan)

__all__ = ["HostParkingLot", "LotStats", "tree_nbytes",
           "offload_remat_policy", "remat_policy_for",
           "RUNTIME_PHASE_SEQUENCE", "OffloadExecutor", "OffloadPlan"]
