"""Offline binary-vocabulary trainer (DBoW2 vocabulary-creation analog).

Counterpart of the JAX package's ``tools/train_vocabulary.py``: binary
descriptors are harvested from one or more TUM-format sequences (or plain
image directories) with the port's own extractor (FAST corners and steered
binary descriptors, ``loop/features.py``, the features the port's loop
detector uses), a hierarchical k x k vocabulary is trained by k-medians
(``loop/vocabulary.py``), and the result is saved as ``.npz`` (arrays
``level1`` and ``level2``, which either package loads) for
``--loop_detection_vocabulary_path``.

    python -m badslam_torch.tools.train_vocabulary OUT.npz DATASET_DIR [DATASET_DIR ...]
        [--k 32] [--iters 8] [--frame_stride 5] [--max_features 500]
        [--max_descriptors 200000]

A TUM dataset dir is recognized by its associated.txt/rgb.txt; otherwise
every .png in the directory is used. Images are decoded by the port's PNG
reader (``io/png.py``), without OpenCV; JPEG input is refused.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from badslam_torch.io.png import read_png
from badslam_torch.loop.features import describe_keypoints, gray_from_rgb
from badslam_torch.loop.vocabulary import BinaryVocabulary


def _sequence_images(path: str, stride: int):
    """Yield grayscale u8 frames from a TUM dataset dir or an image dir."""
    rgb_list = None
    for name in ("associated.txt", "rgb.txt"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            rgb_list = p
            break
    files = []
    if rgb_list:
        with open(rgb_list) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                # associated.txt: ts rgb ts depth; rgb.txt: ts rgb
                files.append(os.path.join(path, line.split()[1]))
    else:
        files = sorted(
            os.path.join(path, n) for n in os.listdir(path)
            if n.lower().endswith((".png", ".jpg", ".jpeg")))
    for fp in files[::max(1, stride)]:
        if not fp.lower().endswith(".png"):
            raise ValueError(
                f"{fp}: only PNG images are read (the port decodes PNG itself "
                f"and does not use OpenCV); convert JPEG images to PNG first")
        img = read_png(fp)
        if img.ndim == 3:
            img = gray_from_rgb(img[..., :3])
        yield np.asarray(img, np.uint8)


def harvest_descriptors(dirs, frame_stride: int = 5, max_features: int = 500,
                        max_descriptors: int = 200_000, seed: int = 0) -> np.ndarray:
    """The extractor's descriptors from the given sequences, capped at
    `max_descriptors` by a draw from default_rng(seed)."""
    chunks = []
    for d in dirs:
        for gray in _sequence_images(d, frame_stride):
            _, _, desc = describe_keypoints(gray, max_features)
            if len(desc):
                chunks.append(desc)
    if not chunks:
        return np.zeros((0, 32), np.uint8)
    desc = np.concatenate(chunks)
    if len(desc) > max_descriptors:
        rng = np.random.default_rng(seed)
        desc = desc[rng.choice(len(desc), max_descriptors, replace=False)]
    return desc


def train_vocabulary(dirs, out_path: str, k: int = 32, iters: int = 8,
                     frame_stride: int = 5, max_features: int = 500,
                     max_descriptors: int = 200_000, seed: int = 0,
                     quiet: bool = False) -> BinaryVocabulary:
    desc = harvest_descriptors(dirs, frame_stride, max_features, max_descriptors, seed)
    if len(desc) < k * k:
        raise SystemExit(
            f"only {len(desc)} descriptors harvested; need >= {k * k} "
            f"(k^2) to train a meaningful vocabulary")
    if not quiet:
        print(f"training k={k} x {k} vocabulary on {len(desc)} descriptors "
              f"from {len(dirs)} sequence(s)...")
    vocab = BinaryVocabulary.train(desc, k=k, iters=iters, seed=seed)
    vocab.save(out_path)
    if not quiet:
        print(f"saved {vocab.num_words}-word vocabulary to {out_path}")
    return vocab


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("output", help="output vocabulary .npz path")
    p.add_argument("datasets", nargs="+", help="TUM dataset dirs (or plain image dirs)")
    p.add_argument("--k", type=int, default=32,
                   help="branching factor; vocabulary has k^2 words")
    p.add_argument("--iters", type=int, default=8,
                   help="k-medians refinement iterations per level")
    p.add_argument("--frame_stride", type=int, default=5, help="use every Nth frame")
    p.add_argument("--max_features", type=int, default=500,
                   help="features per frame")
    p.add_argument("--max_descriptors", type=int, default=200_000,
                   help="descriptor cap before training (subsampled)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    a = p.parse_args(argv)
    train_vocabulary(a.datasets, a.output, k=a.k, iters=a.iters,
                     frame_stride=a.frame_stride, max_features=a.max_features,
                     max_descriptors=a.max_descriptors, seed=a.seed, quiet=a.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
