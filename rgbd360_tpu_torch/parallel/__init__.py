"""Distribution over ranks on `torch.distributed` (twin of
`rgbd360_tpu/parallel/`): the sharded map-scale stages and the
multi-process glue."""

from rgbd360_tpu_torch.parallel.sharded import (
    make_mesh,
    sharded_plane_scan,
    distributed_pose_graph,
    sharded_pair_align,
)
from rgbd360_tpu_torch.parallel.multihost import (
    all_hosts_agree,
    global_mesh,
    global_to_host_local,
    host_local_to_global,
    hosts_mesh,
    initialize,
)

__all__ = [
    "make_mesh",
    "sharded_plane_scan",
    "distributed_pose_graph",
    "sharded_pair_align",
    "initialize",
    "global_mesh",
    "hosts_mesh",
    "host_local_to_global",
    "global_to_host_local",
    "all_hosts_agree",
]
