"""Learnable synthetic stand-ins for MNIST / FMNIST / CIFAR-10 / CINIC-10.

The paper's datasets are not bundled with the repository, so this module
generates class-conditional image distributions with the same shapes and
difficulty *ordering* (mnist < fmnist < cifar <= cinic) so the paper's
*relative* claims (rounds-to-target per aggregation method) can be
reproduced.  Construction per class:

  template_c  = smoothed random field (low-frequency, class-specific)
  x           = a * template_c + b * distractor + sigma * noise,

with per-sample amplitude jitter, a shared distractor field (makes classes
non-orthogonal), and per-dataset noise levels.  Labels are balanced.

A numpy copy of the JAX package's ``repro.data.synthetic`` (same seed,
bit-identical arrays), with its token-stream LM task
(:func:`make_lm_dataset`).
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np

SPECS = {
    #              H   W  C  noise  distract
    "mnist":      (28, 28, 1, 0.90, 0.6),
    "fmnist":     (28, 28, 1, 1.20, 0.9),
    "cifar":      (32, 32, 3, 1.60, 1.2),
    "cinic":      (32, 32, 3, 1.90, 1.4),
}

N_CLASSES = 10


class Dataset(NamedTuple):
    x: np.ndarray          # (n, H, W, C) float32 in ~[-1, 2]
    y: np.ndarray          # (n,) int32


def _smooth_field(rng: np.random.Generator, h: int, w: int, c: int,
                  cutoff: int = 6) -> np.ndarray:
    """Low-frequency random field via truncated 2-D Fourier synthesis."""
    field = np.zeros((h, w, c), np.float32)
    ys = np.linspace(0, 2 * np.pi, h, endpoint=False)[:, None, None]
    xs = np.linspace(0, 2 * np.pi, w, endpoint=False)[None, :, None]
    for fy in range(cutoff):
        for fx in range(cutoff):
            amp = rng.normal(size=(1, 1, c)) / (1.0 + fy + fx)
            phase = rng.uniform(0, 2 * np.pi, size=(1, 1, c))
            field += (amp * np.cos(fy * ys + fx * xs + phase)).astype(
                np.float32)
    field /= max(np.abs(field).max(), 1e-6)
    return field


def make_dataset(name: str, n_per_class: int, seed: int = 42,
                 split: str = "train") -> Dataset:
    h, w, c, noise, distract = SPECS[name]
    # class templates depend only on (name, seed); train/test share them
    # zlib.crc32: stable across processes (python's hash() is salted,
    # which would silently break the paper's fixed-seed-42 reproducibility)
    trng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(name.encode())]))
    templates = np.stack([_smooth_field(trng, h, w, c)
                          for _ in range(N_CLASSES)])
    distractor = _smooth_field(trng, h, w, c)

    srng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(name.encode()), 0 if split == "train" else 1]))
    n = n_per_class * N_CLASSES
    y = np.repeat(np.arange(N_CLASSES, dtype=np.int32), n_per_class)
    srng.shuffle(y)
    amp = srng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
    damp = srng.normal(0, 1, size=(n, 1, 1, 1)).astype(np.float32)
    eps = srng.normal(0, 1, size=(n, h, w, c)).astype(np.float32)
    x = (amp * templates[y] + distract * damp * distractor[None]
         + noise * eps)
    return Dataset(x.astype(np.float32), y)


# ------------------------------------------------------------ LM stream ----
def make_lm_dataset(vocab: int, seq_len: int, n_seqs: int,
                    seed: int = 42, p_follow: float = 0.9) -> np.ndarray:
    """Bigram-table token streams: tokens (n_seqs, seq_len) int32.

    next = T[prev] with prob ``p_follow`` (T a fixed random permutation),
    else uniform.  A LM that learns the table reaches cross-entropy
    ~= H(p_follow) + (1-p_follow) * ln(vocab), far below ln(vocab) -- a
    measurable target for the fine-tuning examples.
    """
    rng = np.random.default_rng(seed)
    table = rng.permutation(vocab)
    toks = np.zeros((n_seqs, seq_len), np.int64)
    toks[:, 0] = rng.integers(0, vocab, n_seqs)
    for t in range(1, seq_len):
        follow = rng.random(n_seqs) < p_follow
        toks[:, t] = np.where(follow, table[toks[:, t - 1]],
                              rng.integers(0, vocab, n_seqs))
    return toks.astype(np.int32)
