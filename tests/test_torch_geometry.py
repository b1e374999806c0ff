"""badslam_torch geometry against badslam_tpu: se3, solve_psd, camera.

Inputs come from numpy with a fixed seed and go to both packages. Tolerance
atol 1e-6: both run the same float32 formulas, so they differ only by the
order in which XLA and PyTorch evaluate them (a few ulp at values <= ~1).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.geometry import linalg as jlinalg
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.geometry.camera import PinholeCamera as JCamera
from badslam_torch.convert import camera_from_numpy
from badslam_torch.geometry import linalg as tlinalg
from badslam_torch.geometry import se3 as tse3

torch.set_num_threads(1)

ATOL = 1e-6


def _rand_poses(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return q, t


def _both(q, t):
    return (jse3.SE3(jnp.array(q), jnp.array(t)),
            tse3.SE3(torch.from_numpy(q), torch.from_numpy(t)))


def _close(a_jax, b_torch, atol=ATOL):
    np.testing.assert_allclose(b_torch.numpy(), np.asarray(a_jax), atol=atol, rtol=0)


def test_se3_mul_inverse_matrix():
    rng = np.random.default_rng(0)
    ja, ta = _both(*_rand_poses(rng, 16))
    jb, tb = _both(*_rand_poses(rng, 16))
    jm, tm = jse3.mul(ja, jb), tse3.mul(ta, tb)
    _close(jm.q, tm.q)
    _close(jm.t, tm.t)
    ji, ti = jse3.inverse(ja), tse3.inverse(ta)
    _close(ji.q, ti.q)
    _close(ji.t, ti.t)
    _close(jse3.quat_to_matrix(ja.q), tse3.quat_to_matrix(ta.q))
    _close(jse3.matrix_to_quat(jse3.quat_to_matrix(ja.q)),
           tse3.matrix_to_quat(tse3.quat_to_matrix(ta.q)))


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0], ids=["tiny", "small", "large"])
def test_se3_exp_log(scale):
    rng = np.random.default_rng(1)
    xi = (scale * rng.normal(size=(32, 6))).astype(np.float32)
    je, te = jse3.exp(jnp.array(xi)), tse3.exp(torch.from_numpy(xi))
    _close(je.q, te.q)
    _close(je.t, te.t)
    _close(jse3.log(je), tse3.log(te), atol=ATOL * max(1.0, 10 * scale))


def test_se3_identity_on_device_argument():
    ident = tse3.identity("cpu", (2,))
    assert ident.q.shape == (2, 4) and ident.t.shape == (2, 3)
    _close(jse3.identity((2,)).q, ident.q)


def test_solve_psd_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    H = (A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    xj = np.asarray(jlinalg.solve_psd(jnp.array(H), jnp.array(b)))
    xt = tlinalg.solve_psd(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    # Relative: the solution grows with the conditioning of H.
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=ATOL)


def test_solve_psd_singular_is_finite_like_jax():
    H = np.zeros((6, 6), np.float32)
    H[0, 0] = 2.0
    b = np.ones(6, np.float32)
    xj = np.asarray(jlinalg.solve_psd(jnp.array(H), jnp.array(b)))
    xt = tlinalg.solve_psd(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    assert np.all(np.isfinite(xt))
    np.testing.assert_allclose(xt, xj, rtol=1e-6)


def test_camera_pyramid_level():
    jc = JCamera(fx=525.0, fy=523.5, cx=319.7, cy=241.3, width=640, height=480)
    tc = camera_from_numpy(jc)
    for level in range(5):
        a, b = jc.pyramid_level(level), tc.pyramid_level(level)
        assert (a.width, a.height) == (b.width, b.height)
        for name in ("fx", "fy", "cx", "cy", "fx_inv", "fy_inv", "cx_inv", "cy_inv"):
            assert abs(getattr(a, name) - getattr(b, name)) <= ATOL
    s = jc.scaled(0.5), tc.scaled(0.5)
    assert (s[0].width, s[0].height, s[0].fx) == (s[1].width, s[1].height, s[1].fx)


def test_import_badslam_torch_leaves_jax_out():
    """The port and chip_smoke.py import neither jax nor any module of the
    JAX package (badslam_tpu), not even its jax-free ones, nor OpenCV."""
    code = (
        "import sys\n"
        "import badslam_torch, badslam_torch.cli, badslam_torch.frontend\n"
        "import badslam_torch.ba.scheme, badslam_torch.probe_gather\n"
        "import badslam_torch.synthetic, badslam_torch.convert\n"
        "import badslam_torch.ops.kernels, badslam_torch.io.state\n"
        "import badslam_torch.ba.pcg, badslam_torch.ba.intrinsics_opt\n"
        "import badslam_torch.utils.lm\n"
        "import badslam_torch.loop, badslam_torch.loop.closure\n"
        "import badslam_torch.loop.detector, badslam_torch.loop.features\n"
        "import badslam_torch.loop.pose_graph, badslam_torch.loop.ransac\n"
        "import badslam_torch.loop.thread, badslam_torch.loop.vocabulary\n"
        "import badslam_torch.geometry.se3_np\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "tpu = sorted(m for m in sys.modules if m.split('.')[0] == 'badslam_tpu')\n"
        "assert not tpu, tpu\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'cv2' not in sys.modules\n"
    )
    import os

    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_matches_jax_config():
    """badslam_torch.config is a copy of badslam_tpu.config: the same field
    names, in the same order, with the same types and defaults, and the
    same derived values. A new flag in the JAX package fails here."""
    import dataclasses

    from badslam_tpu.config import BadSlamConfig as JConfig
    from badslam_torch.config import BadSlamConfig as TConfig

    def spec(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else f.default)
            out.append((f.name, str(f.type), default))
        return out

    assert spec(TConfig) == spec(JConfig)
    j, t = JConfig(), TConfig()
    for n in range(0, 40):
        assert t.min_observation_count_at(n) == j.min_observation_count_at(n)
    assert t.pyramid_sizes(480, 640) == j.pyramid_sizes(480, 640)
