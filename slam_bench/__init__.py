"""The benchmark of badslam_torch: closed-loop RGB-D sessions on one card,
judged on frames per second and frame-time tails (see README.md)."""
