"""The port's generic LM optimizer (badslam_torch/utils/lm.py) against the
JAX package, on the three cases of tests/test_lm.py (line fit, exponential
fit, Schur-structured toy problem), inputs made with numpy from the same
seeds.

Tolerance: the solution x held to the JAX package's at atol 1e-4, and each
to the known truth at test_lm.py's own bounds. Both solve the same float32
damped normal equations; the iteration counts of the dense LM are equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from badslam_tpu.utils import lm as jlm
from badslam_torch.utils import lm as tlm

torch.set_num_threads(1)

ATOL = 1e-4


def test_lm_line_fitting_matches_jax():
    xs = np.random.default_rng(0).uniform(-2, 2, 50).astype(np.float32)
    gt = np.array([1.7, -0.3], np.float32)
    ys = gt[0] * xs + gt[1]
    want = jlm.optimize(lambda p: p[0] * jnp.array(xs) + p[1] - jnp.array(ys),
                        jnp.zeros(2, jnp.float32))
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    got = tlm.optimize(lambda p: p[0] * tx + p[1] - ty, torch.zeros(2))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.x.numpy(), gt, atol=1e-5, rtol=0)
    assert float(got.cost) < 1e-9
    assert got.iterations == int(want.iterations)


def test_lm_nonlinear_matches_jax():
    xs = np.random.default_rng(1).uniform(0, 1, 40).astype(np.float32)
    ys = np.exp(0.8 * xs) + 0.25
    jx, jy = jnp.array(xs), jnp.array(ys)
    want = jlm.optimize(lambda p: jnp.exp(p[0] * jx) + p[1] - jy,
                        jnp.array([0.2, 0.0], jnp.float32))
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    got = tlm.optimize(lambda p: torch.exp(p[0] * tx) + p[1] - ty,
                       torch.tensor([0.2, 0.0]))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.x.numpy(), [0.8, 0.25], atol=1e-4, rtol=0)
    assert got.iterations == int(want.iterations)


def test_lm_schur_matches_jax():
    rng = np.random.default_rng(2)
    nb = 20
    obs = rng.normal(size=(nb, 3)).astype(np.float32)
    a_gt = np.array([0.5, -1.0], np.float32)
    b_gt = rng.normal(size=(nb, 1)).astype(np.float32)

    def model(xp, a, b, o):
        return o * b + a[0] + a[1] * o * o

    jo = jnp.array(obs)
    jt = model(jnp, jnp.array(a_gt), jnp.array(b_gt), jo)
    ja, jb, jcost = jlm.optimize_schur(lambda a, b: model(jnp, a, b, jo) - jt,
                                       jnp.zeros(2), jnp.zeros((nb, 1)), max_iterations=30)
    to = torch.from_numpy(obs)
    tt = model(torch, torch.from_numpy(a_gt), torch.from_numpy(b_gt), to)
    ta, tb, tcost = tlm.optimize_schur(lambda a, b: model(torch, a, b, to) - tt,
                                       torch.zeros(2), torch.zeros((nb, 1)),
                                       max_iterations=30)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=0)
    assert float(tcost) < 1e-8
    np.testing.assert_allclose(ta.numpy(), a_gt, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tb.numpy(), b_gt, atol=1e-3, rtol=0)
