"""Keyframe features for loop detection (host numpy, no OpenCV).

Counterpart of ``badslam_tpu/loop/features.py``. The JAX package extracts
OpenCV's ORB; the port has its own extractor in numpy, which runs on the
loop-detection thread:

  * FAST-9 corners on the 16-pixel Bresenham circle of radius 3, threshold
    12 on the u8 image (a contiguous arc of at least 9 ring pixels all
    brighter, or all darker, than the center by more than the threshold);
  * corner score: the larger of the summed excesses of the brighter and of
    the darker ring pixels over the threshold; 3x3 non-maximum suppression
    on it (ties go to the first pixel in raster order); the strongest
    `max_features` kept, at least EDGE pixels from the border;
  * orientation: the intensity centroid over the disc of radius
    PATCH_RADIUS (atan2 of the first moments);
  * a 256-bit descriptor: comparisons of 5x5 box-smoothed intensities at
    point pairs of a fixed pattern drawn once from
    ``numpy.random.default_rng(PATTERN_SEED)`` (Gaussian, within radius
    PAIR_RADIUS), steered by the orientation quantized to ANGLE_BINS
    directions; packed as [N, 32] u8 (bit i is pair i, numpy.packbits
    order).

The descriptors differ from OpenCV's (whose learned pair table is not in
the repository), so the two packages agree on loop-closure outcomes, not
bits. Camera points come from the keypoints as the JAX package unprojects
them: the keypoint truncated to its pixel, which is unprojected at its
center, keypoints without depth dropped. Matching (brute force and
vocabulary-bucketed) and `bow_score` are the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from badslam_torch.loop.vocabulary import popcount_rows

FAST_THRESHOLD = 12
# (dx, dy) of the FAST circle, clockwise from the top.
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))
ARC = 9
PATCH_RADIUS = 15   # orientation disc
PAIR_RADIUS = 13    # descriptor pairs lie within this radius (rotated too)
SMOOTH_RADIUS = 2   # 5x5 box
EDGE = max(PATCH_RADIUS, PAIR_RADIUS + SMOOTH_RADIUS)
ANGLE_BINS = 30
PATTERN_SEED = 20240601
DESCRIPTOR_BITS = 256


class KeyframeFeatures(NamedTuple):
    keypoints: np.ndarray    # [N, 2] (x, y) pixel coordinates, f32
    descriptors: np.ndarray  # [N, 32] uint8 packed binary descriptors
    points_local: np.ndarray  # [N, 3] camera-frame 3D points (from depth), f32


def _pattern() -> np.ndarray:
    """[ANGLE_BINS, 256, 2, 2] int (bin, pair, point, (dx, dy)): the pair
    pattern rotated to each orientation bin and rounded to pixels."""
    rng = np.random.default_rng(PATTERN_SEED)
    pts = np.zeros((0, 2))
    while len(pts) < 2 * DESCRIPTOR_BITS:
        p = rng.normal(scale=(2 * PATCH_RADIUS + 1) / 5.0, size=(4 * DESCRIPTOR_BITS, 2))
        pts = np.concatenate([pts, p[np.hypot(p[:, 0], p[:, 1]) <= PAIR_RADIUS]])
    pts = pts[: 2 * DESCRIPTOR_BITS].reshape(DESCRIPTOR_BITS, 2, 2)
    theta = 2.0 * np.pi * np.arange(ANGLE_BINS) / ANGLE_BINS
    c, s = np.cos(theta)[:, None, None], np.sin(theta)[:, None, None]
    x, y = pts[None, ..., 0], pts[None, ..., 1]
    return np.rint(np.stack([c * x - s * y, s * x + c * y], axis=-1)).astype(np.int64)


_PATTERN = _pattern()
_DISC = np.array([(dx, dy) for dy in range(-PATCH_RADIUS, PATCH_RADIUS + 1)
                  for dx in range(-PATCH_RADIUS, PATCH_RADIUS + 1)
                  if dx * dx + dy * dy <= PATCH_RADIUS * PATCH_RADIUS], np.int64)


def fast_corners(gray_u8: np.ndarray, threshold: int = FAST_THRESHOLD,
                 edge: int = EDGE) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FAST-9 corners at least `edge` pixels from the border, after 3x3
    non-maximum suppression of the corner score. Returns (x, y, score),
    int64, in raster order."""
    img = np.asarray(gray_u8, np.int16)
    h, w = img.shape
    # Scores over the keypoint region grown by one pixel, so that the
    # suppression compares every kept pixel with real neighbours.
    y0, y1, x0, x1 = edge - 1, h - edge + 1, edge - 1, w - edge + 1
    if y1 - y0 < 3 or x1 - x0 < 3:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty
    center = img[y0:y1, x0:x1]
    # The high-speed test: an arc of 9 covers at least two of the four
    # compass points, all brighter or all darker.
    compass = np.stack([img[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
                        for dx, dy in CIRCLE[::4]])
    hi, lo = center + threshold, center - threshold
    cand = ((compass > hi).sum(0) >= 2) | ((compass < lo).sum(0) >= 2)
    cy, cx = np.nonzero(cand)
    ring = np.stack([img[cy + y0 + dy, cx + x0 + dx] for dx, dy in CIRCLE])  # [16, N]
    c = center[cy, cx]
    score = np.zeros(len(cy), np.int64)
    is_corner = np.zeros(len(cy), bool)
    for diff in (ring.astype(np.int64) - (c + threshold), (c - threshold) - ring.astype(np.int64)):
        on = diff > 0
        ext = np.concatenate([on, on[: ARC - 1]])
        run = ext[:16].copy()
        for k in range(1, ARC):
            run &= ext[k:k + 16]
        arc = run.any(0)
        is_corner |= arc
        score = np.maximum(score, np.where(arc, np.where(on, diff, 0).sum(0), 0))
    smap = np.zeros(center.shape, np.int64)
    smap[cy, cx] = np.where(is_corner, score, 0)
    # 3x3 non-maximum suppression: strictly above the neighbours before it
    # in raster order, at least the ones after it.
    pad = np.pad(smap, 1)
    core = pad[1:-1, 1:-1]
    keep = core > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[1 + dy:pad.shape[0] - 1 + dy, 1 + dx:pad.shape[1] - 1 + dx]
            keep &= (core > nb) if (dy, dx) < (0, 0) else (core >= nb)
    keep[0, :] = keep[-1, :] = False
    keep[:, 0] = keep[:, -1] = False
    ky, kx = np.nonzero(keep)
    return kx + x0, ky + y0, smap[ky, kx]


def _box_sums(img: np.ndarray, r: int) -> np.ndarray:
    """Sums over the (2r+1)^2 box around each pixel (int64; the image is
    edge-padded by r)."""
    p = np.pad(np.asarray(img, np.int64), r, mode="edge")
    s = np.zeros((p.shape[0] + 1, p.shape[1] + 1), np.int64)
    s[1:, 1:] = p.cumsum(0).cumsum(1)
    k = 2 * r + 1
    return s[k:, k:] - s[:-k, k:] - s[k:, :-k] + s[:-k, :-k]


def orientations(gray_u8: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Intensity-centroid angle (radians) of the disc around each keypoint."""
    vals = np.asarray(gray_u8, np.float64)[y[:, None] + _DISC[None, :, 1],
                                            x[:, None] + _DISC[None, :, 0]]
    m10 = vals @ _DISC[:, 0].astype(np.float64)
    m01 = vals @ _DISC[:, 1].astype(np.float64)
    return np.arctan2(m01, m10)


def describe(gray_u8: np.ndarray, x: np.ndarray, y: np.ndarray,
             angle: np.ndarray) -> np.ndarray:
    """[N, 32] u8 steered binary descriptors of the keypoints."""
    smooth = _box_sums(gray_u8, SMOOTH_RADIUS)
    b = np.rint(angle / (2.0 * np.pi / ANGLE_BINS)).astype(np.int64) % ANGLE_BINS
    pat = _PATTERN[b]                                      # [N, 256, 2, 2]
    vals = smooth[y[:, None, None] + pat[..., 1], x[:, None, None] + pat[..., 0]]
    return np.packbits(vals[..., 0] < vals[..., 1], axis=1)


def _empty() -> KeyframeFeatures:
    return KeyframeFeatures(np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8),
                            np.zeros((0, 3), np.float32))


def gray_from_rgb(rgb_u8: np.ndarray) -> np.ndarray:
    """The detector's gray image of a u8 RGB frame: 0.299 R + 0.587 G +
    0.114 B, truncated to u8."""
    return (0.299 * rgb_u8[..., 0] + 0.587 * rgb_u8[..., 1]
            + 0.114 * rgb_u8[..., 2]).astype(np.uint8)


def describe_keypoints(gray_u8: np.ndarray, max_features: int = 500):
    """The strongest `max_features` corners of the image (equal scores in
    raster order) and their descriptors: (x, y, [N, 32] u8)."""
    x, y, score = fast_corners(gray_u8)
    if len(x) == 0:
        return x, y, np.zeros((0, DESCRIPTOR_BITS // 8), np.uint8)
    order = np.lexsort((np.arange(len(score)), -score))[:max_features]
    x, y = x[order], y[order]
    return x, y, describe(gray_u8, x, y, orientations(gray_u8, x, y))


def extract_features(
    gray_u8: np.ndarray,       # [H, W] uint8 intensity
    depth: np.ndarray,         # [H, W] f32 calibrated depth (0 invalid)
    cam,                       # PinholeCamera (host floats)
    max_features: int = 500,
) -> KeyframeFeatures:
    x, y, desc = describe_keypoints(gray_u8, max_features)
    if len(x) == 0:
        return _empty()
    pts = np.stack([x, y], axis=-1).astype(np.float32)

    # Keep only keypoints with valid depth; unproject at the pixel center.
    h, w = depth.shape
    px = np.clip(pts[:, 0].astype(np.int32), 0, w - 1)
    py = np.clip(pts[:, 1].astype(np.int32), 0, h - 1)
    d = depth[py, px]
    ok = d > 0
    pts, desc, d = pts[ok], desc[ok], d[ok]
    px, py = px[ok], py[ok]

    nx = (px + 0.5 - cam.cx) / cam.fx
    ny = (py + 0.5 - cam.cy) / cam.fy
    pl = np.stack([d * nx, d * ny, d], axis=-1).astype(np.float32)
    return KeyframeFeatures(pts, desc, pl)


def resize_area_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """u8 image resized by area averaging: each output pixel is the mean of
    the source over its footprint (fractional overlaps weighted), rounded
    half up (OpenCV's INTER_AREA at integer factors)."""
    def weights(n_in: int, n_out: int) -> np.ndarray:
        s = n_in / n_out
        lo = np.arange(n_out)[:, None] * s
        j = np.arange(n_in)[None, :]
        return np.clip(np.minimum(lo + s, j + 1) - np.maximum(lo, j), 0, None) / s

    h, w = img.shape
    out = weights(h, height) @ np.asarray(img, np.float64) @ weights(w, width).T
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest resize: output pixel (x, y) takes source pixel
    (floor(x w_in / w_out), floor(y h_in / h_out))."""
    h, w = img.shape
    ys = np.minimum((np.arange(height) * (h / height)).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(width) * (w / width)).astype(np.int64), w - 1)
    return img[ys[:, None], xs[None, :]]


def match_descriptors(da: np.ndarray, db: np.ndarray, max_distance: int = 64,
                      ratio: float = 0.8) -> np.ndarray:
    """Brute-force Hamming matching with Lowe's ratio test. Returns [M, 2]
    index pairs (i in a, j in b)."""
    if len(da) == 0 or len(db) == 0:
        return np.zeros((0, 2), np.int32)
    wa = np.ascontiguousarray(da).view(np.uint64)
    wb = np.ascontiguousarray(db).view(np.uint64)
    dist = popcount_rows(np.bitwise_xor(wa[:, None, :], wb[None, :, :]))  # [Na, Nb]
    # Only the two smallest distances matter (the ratio test).
    if dist.shape[1] >= 2:
        two = np.argpartition(dist, 1, axis=1)[:, :2]
        d2 = np.take_along_axis(dist, two, axis=1)
        first = np.argmin(d2, axis=1)
        best = np.take_along_axis(two, first[:, None], 1)[:, 0]
        best_d = np.take_along_axis(d2, first[:, None], 1)[:, 0]
        second_d = np.take_along_axis(d2, (1 - first)[:, None], 1)[:, 0]
        ok = (best_d < max_distance) & (best_d < ratio * second_d)
    else:
        best = np.zeros(len(da), np.int64)
        best_d = dist[:, 0]
        ok = best_d < max_distance
    ia = np.nonzero(ok)[0]
    return np.stack([ia, best[ia]], axis=-1).astype(np.int32)


def match_descriptors_by_word(da: np.ndarray, wa: np.ndarray, db_: np.ndarray,
                              wb: np.ndarray, k: int, max_distance: int = 64,
                              ratio: float = 0.8) -> np.ndarray:
    """Vocabulary-bucketed matching (DBoW2's direct index): only pairs whose
    level-1 branch (word // k) agrees are compared. `wa`/`wb` are leaf word
    ids from BinaryVocabulary.quantize. Returns [M, 2] pairs under
    match_descriptors' contract."""
    if len(da) == 0 or len(db_) == 0:
        return np.zeros((0, 2), np.int32)
    k = max(int(k), 1)
    ba = wa // k
    bb = wb // k
    order = np.argsort(bb, kind="stable")
    bb_s = bb[order]
    start = np.searchsorted(bb_s, ba, side="left")
    end = np.searchsorted(bb_s, ba, side="right")
    cnt = end - start
    total = int(cnt.sum())
    if total == 0:
        return np.zeros((0, 2), np.int32)
    ia = np.repeat(np.arange(len(da)), cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    jb = order[np.repeat(start, cnt) + offs]

    xa = np.ascontiguousarray(da).view(np.uint64)
    xb = np.ascontiguousarray(db_).view(np.uint64)
    dist = popcount_rows(np.bitwise_xor(xa[ia], xb[jb]))

    # Best and second best per a-feature through one lexsort over (ia, dist).
    o = np.lexsort((dist, ia))
    ia_s, jb_s, d_s = ia[o], jb[o], dist[o]
    first = np.ones(len(o), bool)
    first[1:] = ia_s[1:] != ia_s[:-1]
    best_rows = np.nonzero(first)[0]
    best_i, best_j, best_d = ia_s[best_rows], jb_s[best_rows], d_s[best_rows]
    second_rows = best_rows + 1
    has_second = second_rows < len(o)
    has_second[has_second] &= ia_s[second_rows[has_second]] == best_i[has_second]
    second_d = np.where(has_second, d_s[np.minimum(second_rows, len(o) - 1)], 32 * 8 + 1)
    ok = (best_d < max_distance) & (best_d < ratio * second_d)
    return np.stack([best_i[ok], best_j[ok]], axis=-1).astype(np.int32)


def bow_score(da: np.ndarray, db: np.ndarray, bits: int = 12) -> float:
    """Cosine similarity of histograms of the descriptors' first `bits`
    bits (a cheap bag-of-binary-words score)."""
    if len(da) == 0 or len(db) == 0:
        return 0.0

    def hist(d):
        words = (d[:, 0].astype(np.int32) << 4) | (d[:, 1] >> 4)
        h = np.bincount(words % (1 << bits), minlength=1 << bits).astype(float)
        n = np.linalg.norm(h)
        return h / n if n > 0 else h

    return float(hist(da) @ hist(db))
