"""Seeded synthetic corpora of the benchmark rows (numpy, host).

Copies of the generators of the repository's ``bench.py``, so the same
seeds give the same bytes: the quantized-DCT corpus (the headline row),
the BWT-like row and the incompressible control row.
"""

from __future__ import annotations

import numpy as np


def make_dataset(mib: int, seed: int = 42) -> np.ndarray:
    """DCT-like 64-byte blocks: a short nonzero coefficient prefix, zeros
    after; a few dense "detail" blocks.  Calibrated so the 8-bit reference
    codec lands at ~19.3% -- the ratio it achieves on the real file."""
    n = mib << 20
    rng = np.random.default_rng(seed)
    nblk = n // 64
    k = np.minimum(rng.geometric(1.0 / 7.0, nblk), 40)
    dense = rng.random(nblk) < 0.055
    k = np.where(dense, rng.integers(40, 64, nblk), k)
    vals = rng.integers(-9, 10, (nblk, 64)).astype(np.int8).astype(np.uint8)
    mask = np.arange(64)[None, :] < k[:, None]
    return np.where(mask, vals, 0).astype(np.uint8).reshape(-1)


def make_bwt_dataset(mib: int, seed: int = 7) -> np.ndarray:
    """enwik-bwt-like row: BWT output is bursty — Zipf-length runs of
    skewed symbols broken by literal stretches.  Calibrated so the 8-bit
    codec lands near the reference's 48.8% on enwik9.bwt (README.md:115)."""
    n = mib << 20
    rng = np.random.default_rng(seed)
    m = n // 4
    lens = np.minimum(rng.zipf(1.7, m), 1000).astype(np.int64)
    lit = rng.random(m) < 0.65
    lens = np.where(lit, np.minimum(lens, 80), lens)
    syms = rng.integers(0, 256, m).astype(np.uint8)
    out = np.repeat(syms, lens)[:n]
    litmask = np.repeat(lit, lens)[:n]
    noise = rng.integers(0, 256, n, dtype=np.uint8)
    return np.where(litmask, noise, out).astype(np.uint8)


def make_random_dataset(mib: int, seed: int = 9) -> np.ndarray:
    """Incompressible control row (the memcpy-adjacent worst case)."""
    return np.random.default_rng(seed).integers(
        0, 256, mib << 20, dtype=np.uint8)
