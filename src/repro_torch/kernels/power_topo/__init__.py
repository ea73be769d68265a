from repro_torch.kernels.power_topo.ops import (  # noqa: F401
    fused_cooling, fused_cooling_hier, group_power, group_power_split,
    hall_power)
from repro_torch.kernels.power_topo.ref import (  # noqa: F401
    CduParams, cdu_update_ref, fused_cooling_hier_ref, fused_cooling_ref,
    group_ids, group_power_ref, group_power_split_ref, hall_matrix,
    hall_max_ref, hall_power_ref)
