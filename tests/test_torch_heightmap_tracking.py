"""badslam_torch's pairwise tracker against badslam_tpu's on a non-planar
scene: tests/test_heightmap_tracking.py's heightmap mesh (128x128, 3
scales, photometric residuals only), its three random view pairs and its
initial-pose distortions (strength 0: the ground truth; 0.05 and 0.01),
in both photometric modes.

The mesh and its renderings come from the port's own generator
(badslam_torch.synthetic.heightmap_mesh_scene and render_mesh, held to the
JAX package's in tests/test_torch_tools.py). Both trackers get the same
pyramids (built by the JAX package, carried over with
badslam_torch.convert) and the same initial poses. Where the
JAX tracker converges (its pose within 0.05 of the ground truth, in
norm of the SE(3) log), the port's pose is held to it at atol 1e-4 and
the `converged` flags must agree. Where it diverges (the reference's
gradmag mode diverges at larger strengths too), float order amplified by
a divergent run decides the result, so the pose is not held; such a case
must stay far from the truth in the port as well. On the CPU the held cases agree to
1.3e-5, and only gradmag mode diverges, on the first view pair at
strength 0.05: 0.891 from the truth in JAX (converged False), 1.443 in the
port (converged True).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.geometry import se3_np as s3
from badslam_tpu.ops.pyramid import build_pyramid
from badslam_tpu.tracking.pairwise import track_frame_pairwise as jtrack
from badslam_torch import synthetic as tsyn
from badslam_torch.convert import camera_from_numpy, pyramid_from_numpy
from badslam_torch.tracking.pairwise import track_frame_pairwise as ttrack

import fixtures
import synthetic

torch.set_num_threads(1)

W = H = 128
NUM_SCALES = 3
STRENGTHS = (0.0, 0.05, 0.01)
CONVERGED = 0.05
POSE_ATOL = 1e-4


def _error_norm(q, t, gt: s3.SE3) -> float:
    est = s3.SE3(np.asarray(q, float), np.asarray(t, float))
    return float(np.linalg.norm(s3.log(s3.mul(s3.inverse(est), gt))))


_cases = {}


def _cases_for(use_gradmag: bool):
    """Every (pair, strength) case of the JAX test's loop, with the same
    random draws, tracked by both packages."""
    if use_gradmag in _cases:
        return _cases[use_gradmag]
    rng = np.random.default_rng(0)
    mesh = tsyn.heightmap_mesh_scene(rng)
    cam = synthetic.default_camera(W, H)
    cams = tuple(cam.pyramid_level(i) for i in range(NUM_SCALES))
    tcams = tuple(camera_from_numpy(c) for c in cams)
    kw = dict(baseline_fx=40.0, use_depth=False, use_descriptor=not use_gradmag,
              use_gradmag=use_gradmag, max_iterations=30)
    out = []
    pair = 0
    while pair < 3:
        twists = 0.1 * rng.standard_normal((2, 6))
        images_T_global = [s3.exp(tw) for tw in twists]
        views = []
        for p in images_T_global:
            world_T_frame = s3.inverse(p)
            depth, inten = tsyn.render_mesh(
                cam, mesh, tsyn.SE3(world_T_frame.q, world_T_frame.t))
            if (depth > 0).mean() < 0.5:
                views = None
                break
            frame = fixtures.frame_from_render(cam, depth, inten)
            views.append(build_pyramid(frame.depth, frame.nx, frame.ny, frame.intensity,
                                       NUM_SCALES, gradmag=use_gradmag))
        if views is None:
            continue
        tviews = [pyramid_from_numpy(v, "cpu") for v in views]
        gt = s3.mul(images_T_global[1], s3.inverse(images_T_global[0]))
        for strength in STRENGTHS:
            init = gt if strength == 0.0 else s3.mul(gt, s3.exp(strength * rng.standard_normal(6)))
            q = np.asarray(init.q, np.float32)
            t = np.asarray(init.t, np.float32)
            jr = jtrack(cams, views[1], views[0], jnp.array(q), jnp.array(t),
                        jnp.array(q), jnp.array(t), **kw)
            tq, tt = torch.from_numpy(q), torch.from_numpy(t)
            tr = ttrack(tcams, tviews[1], tviews[0], tq, tt, tq, tt, **kw)
            out.append(dict(pair=pair, strength=strength,
                            jq=np.asarray(jr.q), jt=np.asarray(jr.t),
                            jconv=bool(jr.converged), jerr=_error_norm(jr.q, jr.t, gt),
                            tq=tr.q.numpy(), tt=tr.t.numpy(), tconv=bool(tr.converged),
                            terr=_error_norm(tr.q.numpy(), tr.t.numpy(), gt)))
        pair += 1
    _cases[use_gradmag] = out
    return out


@pytest.mark.parametrize("strength", STRENGTHS, ids=["truth", "s0.05", "s0.01"])
@pytest.mark.parametrize("use_gradmag", [False, True], ids=["descriptor", "gradmag"])
def test_heightmap_tracking_matches_jax(use_gradmag, strength):
    cases = [c for c in _cases_for(use_gradmag) if c["strength"] == strength]
    assert len(cases) == 3
    held = 0
    for c in cases:
        where = f"pair {c['pair']}, JAX error {c['jerr']:.4g}, port {c['terr']:.4g}"
        if c["jerr"] < CONVERGED:
            np.testing.assert_allclose(c["tq"], c["jq"], atol=POSE_ATOL, err_msg=where)
            np.testing.assert_allclose(c["tt"], c["jt"], atol=POSE_ATOL, err_msg=where)
            assert c["tconv"] == c["jconv"], where
            held += 1
        else:
            assert c["terr"] >= CONVERGED, where
    # Only gradmag mode at strength 0.05 diverges (the first view pair).
    assert held == (2 if (use_gradmag and strength == 0.05) else 3)
