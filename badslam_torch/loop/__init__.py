from badslam_torch.loop.detector import LoopDetector  # noqa: F401
from badslam_torch.loop.pose_graph import optimize_pose_graph  # noqa: F401
from badslam_torch.loop.trajectory import (  # noqa: F401
    extrapolate_and_interpolate_keyframe_pose_changes,
)
