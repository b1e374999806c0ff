"""Faults planted in the program underneath a run, to show that the check
catches each fault a cell can have (slam_bench/tests, and
``python3 -m slam_bench.control --fault``). Each is a context manager that
patches the program for the length of the block:

* ``ba_unchanged``: every bundle adjustment call returns with the keyframe
  poses and the map as they were (a step that returns its state unchanged);
* ``ba_frozen``: bundle adjustment creates, merges and deletes surfels as
  it should, but its geometry pass leaves each surfel where it was made and
  its pose pass leaves each keyframe where the tracker put it (BA's
  optimisation left out, its bookkeeping kept);
* ``tracker_unchanged``: the steady frame's tracker returns its initial
  estimate (the same fault in the tracker);
* ``half_chunk``: a chunk of steady frames runs only its first half (half
  of the batch left out);
* ``pose_altered``: each steady frame's pose is moved where it is
  produced, by 0.1 mm along every axis for each frame of the sequence
  before it (an answer altered).

A cell on one chip has no exchange between chips to leave out. The CPU
tests plant each of ``FAULTS``; ``ba_frozen`` (``CARD_FAULTS``) is read on
the card at the cells' sizes only: at the tests' 64x48, BA lowers the
surfels' spread by no more than the noise of one run.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("ba_unchanged", "tracker_unchanged", "half_chunk", "pose_altered")
CARD_FAULTS = ("ba_frozen",)


@contextlib.contextmanager
def planted(name: str):
    from badslam_torch import frontend, steady
    from badslam_torch.ba import scheme
    from badslam_torch.ba.scheme import DirectBA

    patches = []
    if name == "ba_unchanged":
        patches.append((DirectBA, "bundle_adjustment", lambda self, *a, **k: 0))
    elif name == "ba_frozen":
        poses = DirectBA._poses

        def frozen_poses(self, smap, slots, stack, control):
            res = poses(self, smap, slots, stack, control)
            return res._replace(q=stack.q, t=stack.t, moved=torch.zeros_like(res.moved))
        patches += [(scheme, "_position_step", lambda smap, *a, **k: smap),
                    (DirectBA, "_poses", frozen_poses)]
    elif name == "tracker_unchanged":
        track = steady.track_frame_pairwise

        def unchanged(cams, base, tracked, q1, t1, q2, t2, **kw):
            res = track(cams, base, tracked, q1, t1, q2, t2, **kw)
            return res._replace(q=q1.clone(), t=t1.clone())
        patches.append((steady, "track_frame_pairwise", unchanged))
    elif name == "half_chunk":
        chunk = frontend.BadSlam._process_chunk

        def half(self, start, n, marks):
            return chunk(self, start, n // 2, marks)
        patches.append((frontend.BadSlam, "_process_chunk", half))
    elif name == "pose_altered":
        frame = steady.steady_frame

        def altered(*a, **kw):
            out = frame(*a, **kw)
            idx = kw["idx"] if "idx" in kw else a[15]
            return out._replace(t=out.t + 1e-4 * idx.to(out.t.dtype))
        patches += [(steady, "steady_frame", altered), (frontend, "steady_frame", altered)]
    else:
        raise ValueError(f"no fault {name!r}; the faults are {FAULTS + CARD_FAULTS}")
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
