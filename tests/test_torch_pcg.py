"""The port's PCG bundle adjustment (badslam_torch/ba/pcg.py) against the
JAX package.

tests/test_pcg.py's fixture (128x96 rendered plane scene, keyframe 0's
surfels, keyframe 1's pose perturbed), built by the JAX package and carried
into the port (badslam_torch.convert); for the intrinsics cases, with the
camera perturbed and the raw depth miscalibrated by a known cfactor.

The JAX package runs its CG loop inside one jitted program and does not
report the steps it took. Its step count is read off its results: a step
with max_inner_iterations = n gives the same result as one with a larger
limit exactly when the loop stopped by itself after n steps.

Tolerances:
  * residual groups (w, r, jp, jg, ji, jcf): atol 1e-5 x the largest entry
    of each field for depth and intrinsics columns; the descriptor groups
    5e-4 x, the hold of test_torch_mapping.py's descriptors (180 x the
    difference of two bilinear samples, where one ulp of a surfel position
    shows ~180-fold); the cell ids and the descriptor slots: exact;
  * b = -J^T W r, M = diag(J^T W J) and A p for a seeded p: rtol 1e-4 with
    atol 1e-4 x the largest entry of each part (sums of ~10^4 float32
    terms in another order; the per-cell parts by index_add_);
  * after one PCG step (up to 30 CG steps on float32 vectors): poses atol
    1e-5, surfel positions atol 1e-5, descriptors atol 5e-3, the camera
    1e-5 relative, a atol 1e-5, cfactor atol 1e-4 x its largest entry;
    the CG step count: equal;
  * after the outer loop: poses atol 1e-4 (the BA scheme's hold,
    test_torch_ba.py), surfel counts: exact, the camera 5e-5 relative
    (measured 1.35e-5 after three intrinsics updates; test_torch_
    intrinsics.py gives the cause: the 5x5 intrinsics block is
    ill-conditioned, ~1e8, and amplifies the sums' float order).
With the descriptor residuals and a limit of 30 steps the two packages
stop the CG loop after different step counts; see
test_pcg_step_stopping_with_descriptors_is_float_sensitive.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.ba import intrinsics_opt as jio
from badslam_tpu.ba import pcg as jpcg
from badslam_tpu.ba.scheme import DirectBA as JDirectBA
from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu import synthetic as jsyn
from badslam_torch import convert
from badslam_torch.ba import pcg as tpcg
from badslam_torch.ba.scheme import DirectBA as TDirectBA
from badslam_torch.config import BadSlamConfig as TConfig
from badslam_torch.geometry import se3 as tse3

import fixtures

torch.set_num_threads(1)

CAP = 1 << 13
CELL = 4
DEV = "cpu"
DESC_REL = 5e-4
CF_GT = 0.01


def _build(seed, num_kf=3, intrinsics=False):
    """test_pcg.py's build_ba (JAX), its pose perturbation, and with
    `intrinsics` a miscalibrated raw depth and a perturbed camera."""
    rng = np.random.default_rng(seed)
    cam = jsyn.default_camera(128, 96)
    scene = jsyn.random_plane_scene(rng, 4)
    j = JDirectBA(cam, JConfig(max_surfel_count=CAP), surfel_capacity=CAP)
    gt = [jsyn.pose(tx=0.02 * i, ry=0.005 * i) for i in range(num_kf)]
    for i, g in enumerate(gt):
        d, inten = jsyn.render_scene(cam, scene, g)
        f = fixtures.frame_from_render(cam, d, inten)
        j.add_keyframe(f._replace(raw_depth=f.depth), g, i)
    j.create_surfels_for_keyframe(0, filter_new_surfels=False)
    j.surfels = j.surfels._replace(active=j.surfels.valid)
    j.keyframes.set_pose(1, jse3.mul(gt[1], jsyn.pose(tx=0.004, ty=-0.002, rz=0.001)))
    if intrinsics:
        ks = j.keyframes
        depth = np.asarray(ks.depth)
        raw = np.where(depth > 0, 1.0 / (1.0 / np.maximum(depth, 1e-6) - CF_GT), 0.0)
        ks.raw_depth = jnp.array(raw.astype(np.float32))
        j.depth_params = jio.empty_depth_params(cam.height, cam.width, CELL)
        j.cam = cam.with_intrinsics(fx=cam.fx * 1.004, fy=cam.fy * 0.998,
                                    cx=cam.cx + 0.5, cy=cam.cy - 0.5)
    return cam, j


def _port_of(j):
    tcam = convert.camera_from_numpy(j.cam)
    t = TDirectBA(tcam, TConfig(max_surfel_count=CAP), surfel_capacity=CAP, device=DEV)
    t.surfels = convert.surfel_map_from_numpy(j.surfels, DEV)
    t.keyframes = convert.keyframe_store_from_numpy(j.keyframes, tcam, DEV)
    t.depth_params = convert.depth_params_from_numpy(
        np.asarray(j.depth_params.a), np.asarray(j.depth_params.cfactor), DEV)
    return t


@functools.lru_cache(maxsize=None)
def _pair(seed, intrinsics):
    cam, j = _build(seed, intrinsics=intrinsics)
    return cam, j


def _fresh(seed, intrinsics):
    """A JAX DirectBA (shared, not to be mutated) and a new port copy."""
    cam, j = _pair(seed, intrinsics)
    return cam, j, _port_of(j)


def _close(got, want, rel, name=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=name)


def _jax_kf(j, i):
    ks = j.keyframes
    return (ks.depth[i], ks.nx[i], ks.ny[i], ks.intensity[i], ks.raw_depth[i],
            ks.q[i], ks.t[i], ks.valid[i])


CASES = [(False, False), (True, False), (True, True)]
IDS = ["depth", "depth+desc", "depth+desc+intrinsics"]


def _coeff_kw(j, intrinsics):
    wc = j.depth_params.cfactor.shape[1]
    return dict(params=j.depth_params, cell_size=CELL, wc=wc,
                optimize_intrinsics=intrinsics)


@pytest.mark.parametrize("use_desc,intrinsics", CASES, ids=IDS)
def test_coeffs_for_keyframes_match_jax(use_desc, intrinsics):
    cam, j, t = _fresh(31, intrinsics)
    k = t.keyframes.count
    tks = t.keyframes
    tgroups = tpcg._coeffs_for_keyframes(
        t.surfels, t.cam, tks.stack(), tks.stack_raw(), slice(0, k), 40.0, True,
        use_desc, t.depth_params, CELL, int(t.depth_params.cfactor.shape[1]), intrinsics)
    assert len(tgroups) == (3 if use_desc else 1)
    for i in range(k):
        jgroups = jpcg._coeffs_for_keyframe(
            j.surfels, j.cam, _jax_kf(j, i), 40.0, True, use_desc,
            **_coeff_kw(j, intrinsics))
        assert len(jgroups) == len(tgroups)
        for gi, (tg, jg) in enumerate(zip(tgroups, jgroups)):
            rel = 1e-5 if gi == 0 else DESC_REL
            assert tg["jd"] == jg["jd"]
            for name in ("w", "r", "jp", "jg", "ji", "jcf"):
                if jg.get(name) is None:
                    assert tg[name] is None, name
                    continue
                _close(tg[name][i], jg[name], rel, f"kf {i} group {gi} {name}")
            if jg.get("cell") is not None:
                np.testing.assert_array_equal(tg["cell"][i].numpy(), np.asarray(jg["cell"]))
    assert float((tgroups[0]["w"] > 0).sum()) > 2000


def _jax_rhs_and_diagonal(j, use_desc, intrinsics, gauge):
    """b and M as the JAX step's init_scan sums them, from the JAX
    package's own residual groups (numpy sums)."""
    ks = j.keyframes
    k = int(ks.count)
    n = j.surfels.capacity
    c = int(np.prod(j.depth_params.cfactor.shape))
    b = dict(pose=np.zeros((k, 6)), geo=np.zeros(n), desc=np.zeros((n, 2)),
             intr=np.zeros(5), cfactor=np.zeros(c))
    M = {key: np.zeros_like(v) for key, v in b.items()}
    for i in range(k):
        for g in jpcg._coeffs_for_keyframe(j.surfels, j.cam, _jax_kf(j, i), 40.0, True,
                                           use_desc, **_coeff_kw(j, intrinsics)):
            w = np.asarray(g["w"], np.float64)
            wr = w * np.asarray(g["r"], np.float64)
            jp = np.asarray(g["jp"], np.float64)
            b["pose"][i] -= jp.T @ wr
            M["pose"][i] += (w[:, None] * jp ** 2).sum(0)
            if g["jg"] is not None:
                jgeo = np.asarray(g["jg"], np.float64)
                b["geo"] -= jgeo * wr
                M["geo"] += w * jgeo ** 2
            if g["jd"] is not None:
                b["desc"][:, g["jd"]] += wr
                M["desc"][:, g["jd"]] += w
            if g.get("ji") is not None:
                ji = np.asarray(g["ji"], np.float64)
                b["intr"] -= ji.T @ wr
                M["intr"] += (w[:, None] * ji ** 2).sum(0)
            if g.get("jcf") is not None:
                jcf = np.asarray(g["jcf"], np.float64)
                cell = np.asarray(g["cell"])
                np.add.at(b["cfactor"], cell, -jcf * wr)
                np.add.at(M["cfactor"], cell, w * jcf ** 2)
    if intrinsics:
        w2 = jio.A_PRIOR_WEIGHT ** 2
        b["intr"][4] -= w2 * float(j.depth_params.a)
        M["intr"][4] += w2
    b["pose"][gauge] = 0.0
    return b, M


def _seeded_unknowns(k, n, c, seed=7):
    rng = np.random.default_rng(seed)
    return dict(pose=1e-3 * rng.standard_normal((k, 6)), geo=1e-3 * rng.standard_normal(n),
                desc=0.1 * rng.standard_normal((n, 2)), intr=1e-6 * rng.standard_normal(5),
                cfactor=1e-3 * rng.standard_normal(c))


def _jax_apply(j, p, use_desc, intrinsics, gauge):
    """A p as the JAX step's apply_A accumulates it, from the JAX package's
    own _apply_groups."""
    ks = j.keyframes
    k = int(ks.count)
    pose = p["pose"].copy()
    pose[gauge] = 0.0
    pj = jpcg.Unknowns(**{key: jnp.array(v if key != "pose" else pose, jnp.float32)
                          for key, v in p.items()})
    out = {key: np.zeros_like(v) for key, v in p.items()}
    for i in range(k):
        groups = jpcg._coeffs_for_keyframe(j.surfels, j.cam, _jax_kf(j, i), 40.0, True,
                                           use_desc, **_coeff_kw(j, intrinsics))
        o_pose, o_geo, o_desc, o_intr, o_cf = jpcg._apply_groups(groups, pj, i)
        out["pose"][i] += np.asarray(o_pose)
        if o_geo is not None:
            out["geo"] += np.asarray(o_geo)
        for slot, contrib in o_desc:
            out["desc"][:, slot] += np.asarray(contrib)
        if o_intr is not None:
            out["intr"] += np.asarray(o_intr)
        for cell, contrib in o_cf:
            np.add.at(out["cfactor"], np.asarray(cell), np.asarray(contrib))
    if intrinsics:
        out["intr"][4] += jio.A_PRIOR_WEIGHT ** 2 * p["intr"][4]
    out["pose"][gauge] = 0.0
    return out


def _system(t, use_desc, intrinsics, gauge):
    ks = t.keyframes
    c = t.config
    return tpcg.PCGSystem(t.surfels, t.cam, ks.stack(), ks.stack_raw(), t.depth_params,
                          baseline_fx=c.baseline_fx, use_depth=True,
                          use_descriptor=use_desc, gauge_kf=gauge, cell_size=CELL,
                          optimize_intrinsics=intrinsics)


@pytest.mark.parametrize("use_desc,intrinsics", CASES, ids=IDS)
def test_rhs_diagonal_and_apply_match_jax(use_desc, intrinsics):
    cam, j, t = _fresh(31, intrinsics)
    system = _system(t, use_desc, intrinsics, gauge=1)
    b, M = system.rhs_and_diagonal()
    want_b, want_M = _jax_rhs_and_diagonal(j, use_desc, intrinsics, gauge=1)
    parts = ["pose", "geo"] + (["desc"] if use_desc else []) + (
        ["intr", "cfactor"] if intrinsics else [])
    for name in parts:
        _close(getattr(b, name), want_b[name], 1e-4, f"b.{name}")
        _close(getattr(M, name), want_M[name], 1e-4, f"M.{name}")
    assert float(b.pose[1].abs().sum()) == 0.0  # the gauge keyframe
    k, n, c = system.sizes
    p = _seeded_unknowns(k, n, c)
    got = system.apply(tpcg.Unknowns(**{key: torch.tensor(v, dtype=torch.float32)
                                        for key, v in p.items()}))
    want = _jax_apply(j, p, use_desc, intrinsics, gauge=1)
    for name in parts:
        _close(getattr(got, name), want[name], 1e-4, f"Ap.{name}")


def _jax_step(j, use_desc, intrinsics, max_inner, gauge=0):
    ks = j.keyframes
    return jpcg.pcg_bundle_adjustment_step(
        j.surfels, j.cam, ks.stack(ks.valid), raw_depth=ks.stack_raw(),
        params=j.depth_params, baseline_fx=40.0, use_depth=True,
        use_descriptor=use_desc, max_inner_iterations=max_inner, gauge_kf=gauge,
        cell_size=CELL, optimize_intrinsics=intrinsics)


def _same(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def _port_step(t, use_desc, intrinsics, max_inner):
    ks = t.keyframes
    return tpcg.pcg_bundle_adjustment_step(
        t.surfels, t.cam, ks.stack(ks.valid), raw_depth=ks.stack_raw(),
        params=t.depth_params, baseline_fx=40.0, use_depth=True,
        use_descriptor=use_desc, max_inner_iterations=max_inner, gauge_kf=0,
        cell_size=CELL, optimize_intrinsics=intrinsics)


def _jax_steps_taken(j, use_desc, intrinsics, max_inner, full):
    """The least limit whose result is the JAX package's own `full` one
    (by bisection: a limit gives that result exactly from the step count
    on)."""
    lo, hi = 0, max_inner
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _same(_jax_step(j, use_desc, intrinsics, mid)[1:3], full[1:3]):
            hi = mid
        else:
            lo = mid
    return hi


@pytest.mark.parametrize("use_desc,intrinsics,max_inner", [
    (False, False, 30), (False, False, 8), (True, False, 8), (True, True, 30)],
    ids=["depth", "depth-8-steps", "depth+desc-8-steps", "depth+desc+intrinsics"])
def test_pcg_step_matches_jax(use_desc, intrinsics, max_inner):
    """One outer iteration: the CG stops after the same number of steps
    (15 and 4 of 30 where it stops by itself, here) and the updates agree."""
    cam, j, t = _fresh(31, intrinsics)
    ks = t.keyframes
    res = _port_step(t, use_desc, intrinsics, max_inner)
    jres = _jax_step(j, use_desc, intrinsics, max_inner)
    n = res.cg_steps
    # The JAX package took exactly n steps: a limit of n gives its own
    # result (where n is below the limit), and one of n - 1 does not.
    assert 0 < n <= max_inner
    if n < max_inner:
        assert _same(_jax_step(j, use_desc, intrinsics, n)[1:3], jres[1:3])
    assert not _same(_jax_step(j, use_desc, intrinsics, n - 1)[1:3], jres[1:3])
    print(f"CG steps: port {n}, JAX {n} (limit {max_inner})")

    jmap, jq, jt, jcam, jparams = jres
    k = ks.count
    np.testing.assert_allclose(res.q.numpy(), np.asarray(jq)[:k], atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(jt)[:k], atol=1e-5, rtol=0)
    v = np.asarray(jmap.valid)
    np.testing.assert_allclose(res.smap.pos.numpy()[v], np.asarray(jmap.pos)[v],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.smap.desc.numpy()[v], np.asarray(jmap.desc)[v],
                               atol=5e-3, rtol=0)
    assert float(torch.linalg.vector_norm(res.t[1] - t.keyframes.t[1])) > 1e-4
    if intrinsics:
        np.testing.assert_allclose(
            [res.cam.fx, res.cam.fy, res.cam.cx, res.cam.cy],
            [float(jcam.fx), float(jcam.fy), float(jcam.cx), float(jcam.cy)],
            rtol=1e-5, atol=0)
        assert res.cam.fx != t.cam.fx
        np.testing.assert_allclose(float(res.params.a), float(jparams.a), atol=1e-5, rtol=0)
        _close(res.params.cfactor, jparams.cfactor, 1e-4, "cfactor")
    else:
        assert res.cam is t.cam


def test_pcg_step_stopping_with_descriptors_is_float_sensitive():
    """With the descriptor residuals the preconditioned residual norm is far
    from monotone on this fixture (it rises at 9 of the first 30 steps), so
    the rule "3 consecutive steps without a new best" is decided by float
    rounding: the port stops after 15 steps and the JAX package after 20,
    from b, M and A p that agree to 1e-6 (test above). Both stop early, and
    the poses they give agree to the CG's own progress between the two
    stops (5e-4 m on a 4e-3 m move)."""
    cam, j, t = _fresh(31, False)
    res = _port_step(t, True, False, 30)
    full = _jax_step(j, True, False, 30)
    n_jax = _jax_steps_taken(j, True, False, 30, full)
    print(f"CG steps: port {res.cg_steps}, JAX {n_jax} (limit 30)")
    assert 10 < res.cg_steps < 30 and 10 < n_jax < 30
    k = t.keyframes.count
    np.testing.assert_allclose(res.t.numpy(), np.asarray(full[2])[:k], atol=1e-3, rtol=0)
    np.testing.assert_allclose(res.q.numpy(), np.asarray(full[1])[:k], atol=2e-4, rtol=0)


def test_pcg_step_respects_gauge():
    """test_pcg.py's gauge case: the gauge keyframe does not move."""
    cam, j, t = _fresh(33, False)
    ks = t.keyframes
    res = tpcg.pcg_bundle_adjustment_step(t.surfels, t.cam, ks.stack(ks.valid),
                                          gauge_kf=0, max_inner_iterations=10)
    np.testing.assert_allclose(res.q[0].numpy(), ks.q[0].numpy(), atol=1e-7)
    np.testing.assert_allclose(res.t[0].numpy(), ks.t[0].numpy(), atol=1e-7)
    assert float(torch.linalg.vector_norm(res.t[1] - ks.t[1])) > 0


@pytest.mark.parametrize("intrinsics", [False, True], ids=["poses", "intrinsics"])
def test_pcg_bundle_adjustment_matches_jax(intrinsics):
    """The outer loop from test_pcg.py's fixture: surfel creation, normals,
    the PCG steps with the rotating gauge, merge and compaction."""
    _, j0 = _pair(31, intrinsics)
    _, j = _build(31, intrinsics=intrinsics)
    t = _port_of(j)
    jpcg.pcg_bundle_adjustment(j, max_iterations=3, max_inner_iterations=20,
                               optimize_intrinsics=intrinsics)
    tpcg.pcg_bundle_adjustment(t, max_iterations=3, max_inner_iterations=20,
                               optimize_intrinsics=intrinsics)
    print("CG steps per outer iteration (port):", t.cg_steps)
    assert len(t.cg_steps) == 3 and all(0 < s <= 20 for s in t.cg_steps)
    k = t.keyframes.count
    np.testing.assert_allclose(t.keyframes.q[:k].numpy(), np.asarray(j.keyframes.q)[:k],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(t.keyframes.t[:k].numpy(), np.asarray(j.keyframes.t)[:k],
                               atol=1e-4, rtol=0)
    assert t.surfel_count == j.surfel_count > 500
    assert t.intrinsics_updated == j.intrinsics_updated == intrinsics
    if intrinsics:
        np.testing.assert_allclose([t.cam.fx, t.cam.fy, t.cam.cx, t.cam.cy],
                                   [j.cam.fx, j.cam.fy, j.cam.cx, j.cam.cy],
                                   rtol=5e-5, atol=0)
    # test_pcg.py's bound: the perturbed keyframe's relative pose improves.
    gt = [jsyn.pose(tx=0.02 * i, ry=0.005 * i) for i in range(2)]
    err0 = fixtures.relative_pose_error(jse3, j0.keyframes.pose(0), j0.keyframes.pose(1), *gt)
    tk = t.keyframes
    err1 = fixtures.relative_pose_error(
        tse3, tk.pose(0), tk.pose(1), *(convert.pose_from_numpy(g.q, g.t, DEV) for g in gt))
    assert err1 < 0.5 * err0, (err0, err1)
