"""Loop detection: keyframe features, BoW candidates, initial alignment.

Counterpart of ``badslam_tpu/loop/detector.py`` (the reference's
LoopDetector, loop_detector.h:154-277, loop_detector.cc:208-711), host
numpy on the dataset's own images:

  1. per-keyframe features (``features.extract_features``, the port's own
     extractor), optionally on images resized to
     loop_detection_images_width/height;
  2. an on-the-fly binary vocabulary trained after `train_after` keyframes
     (or one loaded from a file), an inverted-index BoW query, a recency
     window in registration order, and temporal consistency (k consecutive
     supporting detections, DLoopDetector);
  3. descriptor matching (vocabulary-bucketed when both keyframes are
     indexed) and 3D-3D RANSAC for the initial relative pose.

The direct refinement, the gates and the pose graph run in the front end
(``frontend.BadSlam._attempt_loop_closure``, ``loop/closure.py``).

Each stage is timed on the host clock into `timings_ms` and marked with a
``record_function`` span; `feature_counts` holds the features per
registered keyframe.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from badslam_torch.geometry import se3_np as s3
from badslam_torch.loop.features import (
    KeyframeFeatures,
    extract_features,
    match_descriptors,
    match_descriptors_by_word,
    resize_area_u8,
    resize_nearest,
)
from badslam_torch.loop.ransac import ransac_point_cloud_alignment
from badslam_torch.loop.vocabulary import BinaryVocabulary, BowDatabase, l1_score


def average_poses(poses: List[s3.SE3]) -> s3.SE3:
    """AveragePose (util.h:46): mean translation and normalized mean
    quaternion, hemispheres aligned to the first."""
    t = np.mean([np.asarray(p.t, float) for p in poses], axis=0)
    q0 = np.asarray(poses[0].q, float)
    qs = []
    for p in poses:
        q = np.asarray(p.q, float)
        qs.append(q if q @ q0 >= 0 else -q)
    q = np.mean(qs, axis=0)
    return s3.SE3(q / np.linalg.norm(q), t)


def _stage_timer():
    return {"extract": [], "quantize": [], "query": [], "match+ransac": []}


@dataclass
class LoopDetector:
    """Feature database and detection pipeline on host images."""

    cam: object                       # host PinholeCamera
    recent_window: int = 10           # exclude this many recent keyframes
    min_score: float = 0.3            # DLoopDetector alpha (vs the eta normalization)
    min_matches: int = 25
    # Consecutive supporting detections before the geometric check
    # (DLoopDetector's k; the reference runs k = 3).
    temporal_consistency: int = 3
    max_features: int = 500
    vocabulary_path: str = ""         # pre-trained vocabulary (.npz); empty
                                      # trains one on the fly from the sequence
    train_after: int = 8              # keyframes before on-the-fly training
    images_size: Optional[Tuple[int, int]] = None  # (w, h) detection resize
    # Detection-image frequency [Hz]; > 0 derives the recency window as
    # DLoopDetector does (dislocal = 20 s * f).
    image_frequency: float = 0.0

    # Features keyed by keyframe SLOT (slots are recycled after merging, so
    # ids are not temporal); `_order` is the registration (temporal) order.
    features: Dict[int, KeyframeFeatures] = field(default_factory=dict)
    _order: List[int] = field(default_factory=list)
    _consistent_streak: int = 0
    _last_candidate: int = -1
    _vocab: Optional[BinaryVocabulary] = None
    _db: Optional[BowDatabase] = None
    # DEBUG_LOCKING analog (direct_ba.h:47,231-249): once a detection thread
    # claims the detector, every state-touching call asserts it runs there.
    _owner_thread: Optional[int] = None
    timings_ms: Dict[str, List[float]] = field(default_factory=_stage_timer)
    feature_counts: List[int] = field(default_factory=list)

    def claim_thread_ownership(self) -> None:
        """Called from the owning (detection) thread; from then on all
        detector state is accessed on that thread only."""
        self._owner_thread = threading.get_ident()

    def _check_owner(self) -> None:
        if __debug__ and self._owner_thread is not None:
            assert threading.get_ident() == self._owner_thread, (
                "LoopDetector state accessed off its owning detection thread "
                "(DEBUG_LOCKING analog): route the call through "
                "LoopDetectionThread's work queue")

    def __post_init__(self):
        if self.image_frequency > 0:
            self.recent_window = max(1, int(round(20.0 * self.image_frequency)))
        if self.vocabulary_path:
            self._vocab = BinaryVocabulary.load(self.vocabulary_path)
            self._db = BowDatabase(self._vocab)
        if self.images_size is not None:
            w, h = self.images_size
            if w == self.cam.width and h == self.cam.height:
                self.images_size = None

    def _detection_inputs(self, gray_u8, depth):
        """Resized to loop_detection_images_width/height when they differ
        from the camera (the reference's LoopDetector scales the images and
        the intrinsics): area averaging for gray, nearest for depth."""
        if self.images_size is None:
            return gray_u8, depth, self.cam
        w, h = self.images_size
        return (resize_area_u8(gray_u8, w, h), resize_nearest(depth, w, h),
                self.cam.scaled(w / self.cam.width))

    def _train_vocabulary(self) -> None:
        """On-the-fly vocabulary from the keyframes seen so far, then (re)index
        all of them."""
        desc = np.concatenate(
            [self.features[i].descriptors for i in self._order
             if len(self.features[i].descriptors)] or [np.zeros((0, 32), np.uint8)])
        if len(desc) < 64:
            return
        self._vocab = BinaryVocabulary.train(desc, k=32, iters=4)
        self._db = BowDatabase(self._vocab)
        for i in self._order:
            self._db.add(i, self.features[i].descriptors)

    def add_keyframe(self, gray_u8: np.ndarray, depth: np.ndarray,
                     kf_id: int = None) -> int:
        """Register a keyframe's features under slot `kf_id` (default: the
        next sequential id); returns the id."""
        self._check_owner()
        if kf_id is None:
            kf_id = max(self.features, default=-1) + 1
        if kf_id in self.features:  # recycled slot: drop the old entry
            self._order.remove(kf_id)
        t0 = time.perf_counter()
        with record_function("loop/extract"):
            gray_u8, depth, det_cam = self._detection_inputs(gray_u8, depth)
            self.features[kf_id] = extract_features(gray_u8, depth, det_cam,
                                                    self.max_features)
        t1 = time.perf_counter()
        self._order.append(kf_id)
        with record_function("loop/quantize"):
            if self._db is not None:
                self._db.add(kf_id, self.features[kf_id].descriptors)
            elif len(self._order) >= self.train_after:
                self._train_vocabulary()
        self.timings_ms["extract"].append(1000.0 * (t1 - t0))
        self.timings_ms["quantize"].append(1000.0 * (time.perf_counter() - t1))
        self.feature_counts.append(len(self.features[kf_id].descriptors))
        return kf_id

    def remove_keyframe(self, kf_id: int) -> None:
        """Forget a merged or deleted keyframe's features."""
        self._check_owner()
        if kf_id in self.features:
            del self.features[kf_id]
            self._order.remove(kf_id)
        if self._db is not None:
            self._db.remove(kf_id)
        if self._last_candidate == kf_id:
            self._last_candidate = -1
            self._consistent_streak = 0

    def _temporal_pos(self, kf_id: int) -> int:
        return self._order.index(kf_id)

    def detect_candidate(self, kf_id: int) -> Optional[int]:
        """Inverted-index BoW query plus temporal consistency; returns a
        matched keyframe id or None. Recency counts registration order."""
        self._check_owner()
        t0 = time.perf_counter()
        with record_function("loop/query"):
            out = self._detect_candidate(kf_id)
        self.timings_ms["query"].append(1000.0 * (time.perf_counter() - t0))
        return out

    def _detect_candidate(self, kf_id: int) -> Optional[int]:
        if self._db is None:
            # Detection before the training threshold: train now from the
            # keyframes there are.
            self._train_vocabulary()
        if self._db is None or kf_id not in self._db.vectors:
            return None
        cur_vec = self._db.vectors[kf_id]
        pos = self._temporal_pos(kf_id)
        # max(0, ...): a negative bound would wrap the slice and make the
        # most recent keyframes eligible.
        eligible = set(self._order[: max(0, pos - self.recent_window)])
        if not eligible or not cur_vec:
            return None

        # Normalization by the score against the previous keyframe
        # (DLoopDetector's eta: the expected score of a matching pair).
        norm = max(l1_score(cur_vec, self._db.vectors.get(self._order[pos - 1], {})),
                   1e-3)
        best, best_score = -1, 0.0
        for kf, sc in self._db.query(cur_vec):  # best first
            if kf in eligible:
                best, best_score = kf, sc
                break
        if best < 0 or best_score < self.min_score * norm:
            self._consistent_streak = 0
            self._last_candidate = -1
            return None

        # Temporal consistency: consecutive detections close to each other
        # (in registration order).
        if (self._last_candidate >= 0 and self._last_candidate in self.features
                and abs(self._temporal_pos(best)
                        - self._temporal_pos(self._last_candidate)) <= 3):
            self._consistent_streak += 1
        else:
            self._consistent_streak = 0
        self._last_candidate = best
        if self._consistent_streak + 1 < self.temporal_consistency:
            return None
        return best

    def initial_alignment(self, cur_id: int, matched_id: int,
                          rng: Optional[np.random.Generator] = None
                          ) -> Optional[Tuple[s3.SE3, int]]:
        """Descriptor matching and 3D-3D RANSAC. Returns (cur_T_matched,
        inlier count) or None. Matching is vocabulary-bucketed when both
        keyframes are indexed, brute force otherwise."""
        t0 = time.perf_counter()
        with record_function("loop/match_ransac"):
            out = self._initial_alignment(cur_id, matched_id, rng)
        self.timings_ms["match+ransac"].append(1000.0 * (time.perf_counter() - t0))
        return out

    def _initial_alignment(self, cur_id, matched_id, rng):
        cur = self.features[cur_id]
        old = self.features[matched_id]
        if (self._db is not None and cur_id in self._db.words
                and matched_id in self._db.words):
            pairs = match_descriptors_by_word(
                cur.descriptors, self._db.words[cur_id],
                old.descriptors, self._db.words[matched_id], k=self._vocab.k)
        else:
            pairs = match_descriptors(cur.descriptors, old.descriptors)
        if len(pairs) < self.min_matches:
            return None
        a = old.points_local[pairs[:, 1]]   # matched keyframe's frame
        b = cur.points_local[pairs[:, 0]]   # current keyframe's frame
        pose, inliers = ransac_point_cloud_alignment(
            a, b, threshold=0.05, min_inliers=self.min_matches, rng=rng)
        if pose is None:
            return None
        return pose, int(inliers.sum())
