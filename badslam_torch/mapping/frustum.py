"""Camera frustum intersection for keyframe covisibility.

Counterpart of the device frustum test of ``badslam_tpu/mapping/keyframes.py``
(``_frustum_points``, ``_frustum_axes``, ``_frustum_planes``,
``_pair_intersects``), the rebuild of libvis ``CameraFrustum::Intersects``
(camera_frustum.h:72-225): a keyframe's view volume is the hull of the four
image-corner rays between its min and max observed depth; two volumes
intersect unless an axis separates them. The axes tested are the
bounding-box axes, both frustums' six plane normals, and the cross products
of their edge directions. Everything is batched over keyframes. (The JAX
package's ``mapping/frustum.py`` holds a face-normals-only host version that
nothing calls; the device test is the one covisibility uses.)
"""

from __future__ import annotations

import torch

from badslam_torch.geometry import se3


def frustum_points(cam, q: torch.Tensor, t: torch.Tensor, min_d: torch.Tensor,
                   max_d: torch.Tensor) -> torch.Tensor:
    """[K, 8, 3] world-space corners (image corners x min/max depth) of the
    frustums of keyframes with global_T_frame (q [K, 4], t [K, 3])."""
    corners = []
    for px, py in ((0.0, 0.0), (cam.width * 1.0, 0.0), (0.0, cam.height * 1.0),
                   (cam.width * 1.0, cam.height * 1.0)):
        dx, dy = (px - cam.cx) / cam.fx, (py - cam.cy) / cam.fy
        for dd in (min_d, max_d):
            corners.append(torch.stack([dd * dx, dd * dy, dd], dim=-1))
    local = torch.stack(corners, dim=-2)  # [K, 8, 3]
    R = se3.quat_to_matrix(q)  # [K, 3, 3]
    return torch.einsum("kij,kpj->kpi", R, local) + t[:, None, :]


def _axes(p: torch.Tensor) -> torch.Tensor:
    """[..., 6, 3] edge directions (camera_frustum.h:184-190)."""
    return torch.stack([
        p[..., 7, :] - p[..., 6, :],
        p[..., 3, :] - p[..., 2, :],
        p[..., 5, :] - p[..., 4, :],
        p[..., 1, :] - p[..., 0, :],
        p[..., 2, :] - p[..., 6, :],
        p[..., 0, :] - p[..., 2, :],
    ], dim=-2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _planes(p: torch.Tensor, a: torch.Tensor):
    """Outward plane normals and offsets (camera_frustum.h:192-215)."""
    fwd = _cross(a[..., 5, :], a[..., 4, :])
    right = _cross(a[..., 0, :], a[..., 4, :])
    top = _cross(a[..., 1, :], a[..., 5, :])
    left = _cross(a[..., 4, :], a[..., 2, :])
    bottom = _cross(a[..., 5, :], a[..., 0, :])
    normals = torch.stack([fwd, -fwd, right, top, left, bottom], dim=-2)
    anchors = torch.stack([p[..., 1, :], p[..., 0, :], p[..., 6, :],
                           p[..., 2, :], p[..., 4, :], p[..., 6, :]], dim=-2)
    return normals, -torch.sum(normals * anchors, dim=-1)


def _planes_separate(src: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """[K] bool: some face plane of `src` [K, 8, 3] has all of `other`'s
    corners [K, 8, 3] on its outer side."""
    normals, offsets = _planes(src, _axes(src))
    d = torch.einsum("kpi,kvi->kpv", normals, other) + offsets[..., None]
    return torch.any(torch.all(d >= 0, dim=-1), dim=-1)


def intersects(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """[K] bool SAT intersection of frustum corner sets pa, pb [K, 8, 3]
    (broadcast against each other)."""
    pa, pb = torch.broadcast_tensors(pa, pb)
    bbox = torch.all((pa.amax(-2) >= pb.amin(-2)) & (pb.amax(-2) >= pa.amin(-2)),
                     dim=-1)
    sep = _planes_separate(pa, pb) | _planes_separate(pb, pa)
    aa, ab = _axes(pa), _axes(pb)
    dirs = _cross(aa[..., :, None, :], ab[..., None, :, :]).flatten(-3, -2)
    usable = torch.sum(dirs * dirs, dim=-1) >= 1e-5
    proj_a = torch.einsum("kdi,kvi->kdv", dirs, pa)
    proj_b = torch.einsum("kdi,kvi->kdv", dirs, pb)
    a_min, a_max = proj_a.amin(-1), proj_a.amax(-1)
    b_min, b_max = proj_b.amin(-1), proj_b.amax(-1)
    sep = sep | torch.any(usable & ((a_max <= b_min) | (a_min >= b_max)), dim=-1)
    return bbox & ~sep
