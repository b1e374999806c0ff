"""The port's image gathers against the JAX package and the TPU kernels.

K2 (``tools/probe_pallas_gather.py:82 pallas_gather_rowblock``) is the
gather of ``badslam_tpu/ops/interp.py:18 gather_nearest``; K3
(``:120 pallas_gather_onehot``) the same gather as a windowed one-hot. The
port's plain versions (``ops.interp.gather_nearest_plain`` and
``gather_onehot_plain``) are held to those functions, the Pallas kernels
run in interpret mode on the CPU as ``tools/probe_pallas_gather.py`` runs
them. The CUDA kernels are held to the plain versions by the ``cuda`` tests
of ``tests/test_torch_cuda.py``, which import no JAX (the GPU machine has
none) and skip without a GPU.

Tolerance: exact everywhere. A gather moves values and computes nothing;
the one-hot product of the interpret mode is exact f32 (one 1.0 times the
value, plus zeros).

The TPU kernels leave rows unwritten where the block height does not
divide the image height: their grid is h // block_h. Those rows are
compared nowhere; the port computes every row by the same rule
(``test_reference_leaves_tail_rows_unwritten``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.ops import interp as jinterp
from badslam_torch.ops import interp as tinterp
from badslam_torch.ops import kernels

torch.set_num_threads(1)

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", "tools")]
import probe_pallas_gather as probe  # noqa: E402

from badslam_torch import probe_gather  # noqa: E402


def _field(h, w, seed):
    """The probe's own near-coherent image and index field."""
    img, px, py = probe.make_inputs(h, w, seed)
    img_t, px_t, py_t = probe_gather.make_inputs(h, w, seed)
    np.testing.assert_array_equal(img, img_t)
    np.testing.assert_array_equal(px, px_t)
    np.testing.assert_array_equal(py, py_t)
    return img, px, py


def _assert_same(out_t, out_j):
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64], ids=["i32", "i64"])
def test_plain_gather_matches_jax_take_semantics(index_dtype):
    """In range, negative (wraps once) and out of range (NaN), as jnp.take."""
    rng = np.random.default_rng(0)
    h, w = 6, 5
    img = rng.standard_normal((h, w)).astype(np.float32)
    px = rng.integers(0, w, (40,))
    py = rng.integers(0, h, (40,))
    # Flat index -1 reads the last element; -n the first; n, -n-1 and far
    # beyond give NaN.
    py[:6] = [-1, -h, h, -h - 1, 3 * h, 0]
    px[:6] = [w - 1, 0, 0, w - 1, 2, -1]
    # JAX runs without x64: it gets the same values as int32.
    ref = jinterp.gather_nearest(jnp.array(img), jnp.array(px, jnp.int32),
                                 jnp.array(py, jnp.int32))
    out = tinterp.gather_nearest(torch.from_numpy(img),
                                 torch.from_numpy(px.astype(index_dtype)),
                                 torch.from_numpy(py.astype(index_dtype)))
    _assert_same(out, ref)
    assert np.isnan(out[2:5].numpy()).all() and np.isfinite(out[5:].numpy()).all()


def test_plain_gather_batched_matches_vmapped_jax():
    """[B, H, W] images with [B, N] indices: the JAX package's vmap."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((3, 20, 30)).astype(np.float32)
    px = rng.integers(0, 30, (3, 500)).astype(np.int32)
    py = rng.integers(0, 20, (3, 500)).astype(np.int32)
    ref = jax.vmap(jinterp.gather_nearest)(jnp.array(img), jnp.array(px), jnp.array(py))
    out = tinterp.gather_nearest(torch.from_numpy(img), torch.from_numpy(px),
                                 torch.from_numpy(py))
    _assert_same(out, ref)


def test_bilinear_batched_matches_vmapped_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(2, 24, 32)).astype(np.float32)
    x = rng.uniform(-2, 34, (2, 300)).astype(np.float32)
    y = rng.uniform(-2, 26, (2, 300)).astype(np.float32)
    ref = jax.vmap(jinterp.bilinear_and_gradient)(jnp.array(img), jnp.array(x), jnp.array(y))
    out = tinterp.bilinear_and_gradient(torch.from_numpy(img), torch.from_numpy(x),
                                        torch.from_numpy(y))
    for a, b in zip(out, ref):
        # Same formula, same order: a few ulp at most.
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_plain_gather_matches_rowblock_kernel():
    """K2's plain version against pallas_gather_rowblock in interpret mode,
    at a height its 64-row blocks divide."""
    h, w = 128, 96
    img, px, py = _field(h, w, 3)
    ref = probe.pallas_gather_rowblock(h, w)(jnp.array(img), jnp.array(px), jnp.array(py))
    out = tinterp.gather_nearest_plain(torch.from_numpy(img), torch.from_numpy(px),
                                       torch.from_numpy(py))
    _assert_same(out, ref)


def test_plain_onehot_matches_onehot_kernel():
    """K3's plain version against pallas_gather_onehot in interpret mode,
    with rows moved out of their window and columns out of the image
    (both read 0)."""
    h, w = 32, 64
    img, px, py = _field(h, w, 4)
    py[1, ::5] = np.minimum(py[1, ::5] + 9, h - 1)   # below the window
    py[20, ::3] = np.maximum(py[20, ::3] - 12, 0)    # above the window
    px[9, :4] = [w, w + 5, -1, -7]
    ref = probe.pallas_gather_onehot(h, w)(jnp.array(img), jnp.array(px), jnp.array(py))
    out = tinterp.gather_onehot_plain(torch.from_numpy(img), torch.from_numpy(px),
                                      torch.from_numpy(py))
    _assert_same(out, ref)
    assert (out.numpy() == 0).sum() >= 10
    windowed = probe_gather.windowed_out(py)
    assert windowed > 0 and (out.numpy() == 0).sum() >= windowed


@pytest.mark.parametrize("kernel", ["rowblock", "onehot"])
def test_reference_leaves_tail_rows_unwritten(kernel):
    """At a height the block does not divide, the TPU kernels write only
    rows below (h // block) * block; the port writes every row, by the
    rule the written rows follow."""
    h, w = 100, 32
    block = 64 if kernel == "rowblock" else 8
    img, px, py = _field(h, w, 5)
    make = probe.pallas_gather_rowblock if kernel == "rowblock" else probe.pallas_gather_onehot
    plain = (tinterp.gather_nearest_plain if kernel == "rowblock"
             else tinterp.gather_onehot_plain)
    ref = np.asarray(make(h, w)(jnp.array(img), jnp.array(px), jnp.array(py)))
    out = plain(torch.from_numpy(img), torch.from_numpy(px), torch.from_numpy(py)).numpy()
    written = (h // block) * block
    np.testing.assert_array_equal(out[:written], ref[:written])
    exact = img.reshape(-1)[(py * w + px).reshape(-1)].reshape(h, w)
    np.testing.assert_array_equal(out, exact)  # every row, no window misses here
    assert np.isfinite(out).all()


def test_cpu_tensors_take_the_plain_version():
    before = dict(kernels.launch_counts)
    img = torch.rand(8, 9)
    idx = torch.randint(0, 8, (5,))
    tinterp.gather_nearest(img, idx, idx)
    tinterp.gather_onehot(img, torch.zeros(8, 9, dtype=torch.int32),
                          torch.zeros(8, 9, dtype=torch.int32))
    tinterp.bilinear(img, torch.rand(7) * 9, torch.rand(7) * 8)
    assert kernels.launch_counts == before
    assert kernels.launch_counts[kernels.GATHER] == before[kernels.GATHER]
