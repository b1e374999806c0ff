"""The loop-detection worker thread (LoopDetector::DetectionThreadMain,
loop_detector.cc:793-832).

Counterpart of ``badslam_tpu/loop/thread.py``. Feature extraction, the BoW
query and the RANSAC initial alignment run on a worker thread, overlapping
the tracking of the next frames. Results are consumed only when the front
end drains them (at the next keyframe and at the end of a run), after
waiting for every detection enqueued before, so closures land at fixed
frames whatever the timing: one keyframe later than on the synchronous
path. The worker owns all detector state; removals go through the work
queue too, and so does the registration of a resumed run's keyframes.

One difference from the JAX package, whose worker prints an exception and
carries on: the port's worker stores the first exception, and the next
`wait_through` raises it on the caller's thread, so a failed detection
fails the run.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
from torch.profiler import record_function

from badslam_torch.geometry import se3_np as s3


@dataclass
class DetectionResult:
    kf_id: int
    candidate: Optional[int]
    cur_T_matched: Optional[s3.SE3]   # RANSAC initial alignment
    inliers: int = 0


class LoopDetectionThread:
    def __init__(self, detector):
        self.detector = detector
        self._work: "queue.Queue" = queue.Queue()
        self._results: List[DetectionResult] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._done_seq = -1
        self._next_seq = 0
        self._error: Optional[BaseException] = None
        # Host milliseconds of each keyframe's detection on the worker.
        self.worker_ms: List[float] = []
        self._thread = threading.Thread(target=self._main, daemon=True,
                                        name="loop-detection")
        self._thread.start()

    # -- producer side (the front end's thread) --------------------------

    def enqueue(self, kf_id: int, gray_u8: np.ndarray, depth: np.ndarray) -> int:
        """Queue a keyframe for detection; returns its sequence number."""
        seq = self._next_seq
        self._next_seq += 1
        self._work.put(("add", seq, kf_id, gray_u8, depth))
        return seq

    def register(self, kf_id: int, gray_u8: np.ndarray, depth: np.ndarray) -> int:
        """Queue a keyframe's features without a candidate search (a resumed
        run's keyframes); returns its sequence number."""
        seq = self._next_seq
        self._next_seq += 1
        self._work.put(("register", seq, kf_id, gray_u8, depth))
        return seq

    def remove(self, kf_id: int) -> int:
        seq = self._next_seq
        self._next_seq += 1
        self._work.put(("remove", seq, kf_id, None, None))
        return seq

    def wait_through(self, seq: int) -> None:
        """Block until every operation with sequence <= seq is done; raise
        the worker's stored exception, if any."""
        with self._cv:
            while self._done_seq < seq:
                self._cv.wait(timeout=0.1)
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("loop detection failed on the worker thread") from err

    def drain_results(self) -> List[DetectionResult]:
        with self._lock:
            out = self._results
            self._results = []
        return out

    def stop(self) -> None:
        self._work.put(None)
        self._thread.join(timeout=10)

    # -- worker side -------------------------------------------------------

    def _main(self) -> None:
        # DEBUG_LOCKING analog: from here on, main-thread access asserts.
        self.detector.claim_thread_ownership()
        while True:
            item = self._work.get()
            if item is None:
                return
            op, seq, kf_id, gray, depth = item
            try:
                if op == "remove":
                    self.detector.remove_keyframe(kf_id)
                elif op == "register":
                    self.detector.add_keyframe(gray, depth, kf_id=kf_id)
                else:
                    t0 = time.perf_counter()
                    with record_function("loop_detection_worker"):
                        result = self._detect(kf_id, gray, depth)
                    self.worker_ms.append(1000.0 * (time.perf_counter() - t0))
                    with self._lock:
                        self._results.append(result)
            except Exception as e:  # re-raised on the front end's thread
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._done_seq = seq
                    self._cv.notify_all()

    def _detect(self, kf_id, gray, depth) -> DetectionResult:
        det = self.detector
        det.add_keyframe(gray, depth, kf_id=kf_id)
        candidate = det.detect_candidate(kf_id)
        result = DetectionResult(kf_id, candidate, None)
        if candidate is not None:
            init = det.initial_alignment(kf_id, candidate)
            if init is not None:
                result.cur_T_matched, result.inliers = init
        return result
