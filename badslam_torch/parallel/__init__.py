"""Multi-device bundle adjustment over a mesh of torch devices
(counterpart of ``badslam_tpu/parallel``)."""

from badslam_torch.parallel.mesh import (  # noqa: F401
    AXIS,
    Mesh,
    Planes,
    ShardedMap,
    gather_rows,
    make_mesh,
    shard_rows,
)
from badslam_torch.parallel.sharded import (  # noqa: F401
    estimate_pose_sharded,
    optimize_geometry_plane_streamed,
    optimize_geometry_sharded,
    optimize_keyframe_poses_sharded,
)
from badslam_torch.parallel.streamed import (  # noqa: F401
    activation_geometry_streamed,
    compact_surfels_streamed,
    create_surfels_streamed,
    delete_surfels_streamed,
    merge_surfels_streamed,
    optimize_poses_streamed,
)
