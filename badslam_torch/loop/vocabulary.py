"""Binary bag-of-words vocabulary and inverted-index database (DBoW2 analog).

Counterpart of ``badslam_tpu/loop/vocabulary.py``, host numpy as there: a
two-level k-medians tree over packed 256-bit descriptors, L1-normalized tf
bag-of-words vectors, DBoW2's L1 similarity score, and an inverted index
so that a query costs O(shared postings). The vocabulary is trained on the
fly from the sequence's first keyframes, or loaded from a ``.npz`` with
arrays ``level1`` [k, 32] and ``level2`` [k, k, 32] (u8), the format that
``tools/train_vocabulary.py`` and the JAX package write. Training draws from
``numpy.random.default_rng(seed)`` in the JAX package's order, so the same
descriptors give the same words.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def popcount_rows(x: np.ndarray) -> np.ndarray:
    """Set bits of uint64 words [..., W], summed over the last axis, int32
    (np.bitwise_count, numpy >= 2.0)."""
    return np.bitwise_count(x).sum(axis=-1).astype(np.int32)


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[Na, Nb] Hamming distances between packed binary descriptors."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.int32)
    wa = np.ascontiguousarray(a).view(np.uint64)
    wb = np.ascontiguousarray(b).view(np.uint64)
    return popcount_rows(np.bitwise_xor(wa[:, None, :], wb[None, :, :]))


def _bit_majority(desc: np.ndarray) -> np.ndarray:
    """Bitwise-majority 'mean' of packed binary descriptors [N, B] -> [B]."""
    bits = np.unpackbits(desc, axis=1)
    return np.packbits(bits.mean(axis=0) >= 0.5)


def _kmedians(desc: np.ndarray, k: int, iters: int,
              rng: np.random.Generator) -> np.ndarray:
    """Binary k-medians: Hamming assignment + bit-majority centers."""
    n = len(desc)
    if n <= k:
        pad = desc[rng.integers(0, max(n, 1), size=k - n)] if n else \
            np.zeros((k, 32), np.uint8)
        return np.concatenate([desc, pad]) if n else pad
    centers = desc[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        assign = np.argmin(hamming_matrix(desc, centers), axis=1)
        for c in range(k):
            members = desc[assign == c]
            if len(members) == 0:
                centers[c] = desc[rng.integers(0, n)]
            else:
                centers[c] = _bit_majority(members)
    return centers


class BinaryVocabulary:
    """Two-level hierarchical binary vocabulary: k branches x k leaves =
    k^2 words."""

    def __init__(self, level1: np.ndarray, level2: np.ndarray):
        self.level1 = level1          # [k, 32] u8
        self.level2 = level2          # [k, k, 32] u8
        self.k = level1.shape[0]
        self.num_words = self.k * self.k

    @classmethod
    def train(cls, descriptors: np.ndarray, k: int = 32, iters: int = 6,
              seed: int = 0) -> "BinaryVocabulary":
        rng = np.random.default_rng(seed)
        desc = np.asarray(descriptors, np.uint8)
        level1 = _kmedians(desc, k, iters, rng)
        assign = np.argmin(hamming_matrix(desc, level1), axis=1) \
            if len(desc) else np.zeros(0, np.int64)
        level2 = np.stack([_kmedians(desc[assign == c], k, iters, rng)
                           for c in range(k)])
        return cls(level1, level2)

    def quantize(self, desc: np.ndarray) -> np.ndarray:
        """[N, 32] packed descriptors -> [N] word ids."""
        if len(desc) == 0:
            return np.zeros(0, np.int64)
        c1 = np.argmin(hamming_matrix(desc, self.level1), axis=1)
        words = np.empty(len(desc), np.int64)
        for branch in np.unique(c1):
            sel = c1 == branch
            c2 = np.argmin(hamming_matrix(desc[sel], self.level2[branch]), axis=1)
            words[sel] = branch * self.k + c2
        return words

    def save(self, path: str) -> None:
        np.savez_compressed(path, level1=self.level1, level2=self.level2)

    @classmethod
    def load(cls, path: str) -> "BinaryVocabulary":
        z = np.load(path)
        return cls(np.asarray(z["level1"], np.uint8),
                   np.asarray(z["level2"], np.uint8))


def bow_vector(words: np.ndarray) -> Dict[int, float]:
    """L1-normalized tf vector as a sparse {word: weight} dict."""
    if len(words) == 0:
        return {}
    uniq, counts = np.unique(words, return_counts=True)
    total = float(counts.sum())
    return {int(w): float(c) / total for w, c in zip(uniq, counts)}


def l1_score(va: Dict[int, float], vb: Dict[int, float]) -> float:
    """DBoW2 L1 similarity 1 - 0.5 |va - vb|_1 of L1-normalized vectors,
    over the shared words only."""
    if not va or not vb:
        return 0.0
    s = 0.0
    small, big = (va, vb) if len(va) <= len(vb) else (vb, va)
    for w, x in small.items():
        y = big.get(w)
        if y is not None:
            s += abs(x - y) - x - y
    return -0.5 * s


class BowDatabase:
    """Inverted-index keyframe database: add, remove and query by BoW
    vector (DBoW2 QueryL1)."""

    def __init__(self, vocab: BinaryVocabulary):
        self.vocab = vocab
        self.vectors: Dict[int, Dict[int, float]] = {}
        self.inverted: Dict[int, Dict[int, float]] = {}
        # Per-keyframe word ids in descriptor order (DBoW2's direct index,
        # for word-bucketed matching).
        self.words: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.vectors)

    def add(self, kf_id: int, descriptors: np.ndarray) -> Dict[int, float]:
        if kf_id in self.vectors:
            self.remove(kf_id)
        words = self.vocab.quantize(descriptors)
        vec = bow_vector(words)
        self.vectors[kf_id] = vec
        self.words[kf_id] = words
        for w, weight in vec.items():
            self.inverted.setdefault(w, {})[kf_id] = weight
        return vec

    def remove(self, kf_id: int) -> None:
        self.words.pop(kf_id, None)
        vec = self.vectors.pop(kf_id, None)
        if vec is None:
            return
        for w in vec:
            postings = self.inverted.get(w)
            if postings is not None:
                postings.pop(kf_id, None)
                if not postings:
                    del self.inverted[w]

    def query(self, vec: Dict[int, float], exclude=()) -> List[Tuple[int, float]]:
        """Score every keyframe sharing at least one word with `vec`;
        returns (kf_id, l1_score) best first."""
        acc: Dict[int, float] = {}
        for w, x in vec.items():
            postings = self.inverted.get(w)
            if not postings:
                continue
            for kf, y in postings.items():
                acc[kf] = acc.get(kf, 0.0) + (abs(x - y) - x - y)
        out = [(kf, -0.5 * s) for kf, s in acc.items() if kf not in exclude]
        out.sort(key=lambda p: -p[1])
        return out
