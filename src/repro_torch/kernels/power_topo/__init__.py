from repro_torch.kernels.power_topo.ops import (  # noqa: F401
    fused_cooling, fused_cooling_hier, hall_power)
from repro_torch.kernels.power_topo.ref import (  # noqa: F401
    CduParams, cdu_update_ref, fused_cooling_hier_ref, fused_cooling_ref,
    group_ids, group_power_ref, hall_matrix, hall_max_ref, hall_power_ref)
