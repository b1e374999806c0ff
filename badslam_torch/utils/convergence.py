"""Convergence-criterion analysis tool (offline, numpy).

Counterpart of ``badslam_tpu/utils/convergence.py`` (the reference's
convergence_analysis.cc): record the 6-dof update vector of each
Gauss-Newton iteration of tracking or BA runs, then replay the recorded
sequences against candidate convergence thresholds to pick ones that stop
as early as possible without skipping real steps.

Recording is opt-in (`ConvergenceRecorder.enabled`) and on the host:
callers append update vectors they already hold on the host.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class ConvergenceRecorder:
    """Collects per-optimization sequences of 6-dof update vectors."""

    enabled: bool = False
    sequences: List[np.ndarray] = field(default_factory=list)
    _current: List[np.ndarray] = field(default_factory=list)

    def add_sample(self, x) -> None:
        if self.enabled:
            self._current.append(np.asarray(x, np.float64))

    def end_sequence(self) -> None:
        if self.enabled and self._current:
            self.sequences.append(np.stack(self._current))
            self._current = []

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([s.tolist() for s in self.sequences], f)

    @classmethod
    def load(cls, path: str) -> "ConvergenceRecorder":
        with open(path) as f:
            seqs = [np.asarray(s) for s in json.load(f)]
        rec = cls(sequences=seqs)
        return rec


def criterion_scaled_norm(x: np.ndarray, trans_thr: float,
                          rot_thr: float) -> bool:
    """The shipped criterion (convergence_analysis.h:45-63): converged when
    ||[t, (trans_thr/rot_thr) * w]||^2 < trans_thr."""
    scaled = x.copy()
    scaled[3:] *= trans_thr / rot_thr
    return float(scaled @ scaled) < trans_thr


def analyze(
    sequences: Sequence[np.ndarray],
    trans_thresholds=(1e-5, 1e-6, 1e-7, 1e-8),
    rot_ratio: float = 10.0,
) -> List[Dict]:
    """Replay candidate criteria over recorded sequences.

    For each candidate threshold, reports the mean iterations saved and the
    worst-case residual step magnitude that would have been skipped — the
    quantities the reference's interactive tool plots for a human to pick
    from (convergence_analysis.cc:200-426).
    """
    out = []
    for tt in trans_thresholds:
        rt = tt / rot_ratio
        saved, skipped_mag = [], 0.0
        for seq in sequences:
            n = len(seq)
            stop = n
            for i, x in enumerate(seq):
                if criterion_scaled_norm(x, tt, rt):
                    stop = i + 1
                    break
            saved.append(n - stop)
            if stop < n:
                skipped_mag = max(
                    skipped_mag,
                    float(np.linalg.norm(seq[stop:], axis=1).sum()),
                )
        out.append(dict(
            trans_threshold=tt,
            rot_threshold=rt,
            mean_iterations_saved=float(np.mean(saved)) if saved else 0.0,
            worst_skipped_step_sum=skipped_mag,
        ))
    return out
