"""Planar (columnar) command representation -- the device-side codec IR.

Per block, fixed-capacity columns (see hypersonic_rle_kit_tpu/ops/planar.py
for the full description):

    sym[C]      run symbol of command c
    count[C]    run length (0 for the tail/padding commands)
    lit_len[C]  number of literal bytes preceding the run
    lits[B]     the concatenated literal bytes
    n_cmds      number of real commands (>= 1: a final tail command with
                count == 0 carries the trailing literals)
    n_lits      number of literal bytes

A block decodes as ``concat(lits[s_c : s_c+lit_len[c]] + sym[c]*count[c])``
over commands c, where ``s_c`` is the exclusive prefix sum of ``lit_len``.
The numpy goldens below are the JAX package's, re-homed here because its
``ops`` package imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PlanarBlocks:
    """A batch of blocks in planar command form (leading axis = block)."""

    sym: torch.Tensor        # [nb, C] uint8   run symbols
    count: torch.Tensor      # [nb, C] int32   run lengths (0 for tail/padding)
    lit_len: torch.Tensor    # [nb, C] int32   literals preceding each run
    lits: torch.Tensor       # [nb, B] uint8   literal bytes (tail undefined)
    n_cmds: torch.Tensor     # [nb]    int32   incl. the tail command
    n_lits: torch.Tensor     # [nb]    int32
    block_len: torch.Tensor  # [nb]    int32   uncompressed bytes (<= B)


def capacity_for(block_size: int, min_count: int) -> int:
    """Worst-case command count for a block: one run per ``min_count`` bytes,
    plus the tail command, rounded up to a multiple of 128."""
    c = block_size // max(min_count, 1) + 2
    return (c + 127) // 128 * 128


def host_encode_block(data: np.ndarray, capacity: int, block_size: int,
                      min_count: int = 6,
                      only_sym: int | None = None) -> tuple[np.ndarray, ...]:
    """Golden host encoder for one block (numpy; every encoder must match it
    exactly).  ``only_sym`` restricts emission to runs of that byte (the
    Single family's filter)."""
    n = int(data.shape[0])
    if n > block_size:
        raise ValueError(f"{n} bytes do not fit a {block_size}-byte block")
    sym = np.zeros(capacity, np.uint8)
    count = np.zeros(capacity, np.int32)
    lit_len = np.zeros(capacity, np.int32)
    lits = np.zeros(block_size, np.uint8)
    if n == 0:
        return sym, count, lit_len, lits, np.int32(1), np.int32(0), np.int32(0)

    change = np.flatnonzero(data[1:] != data[:-1]) + 1
    starts = np.concatenate(([0], change))
    lengths = np.concatenate((change, [n])) - starts
    keep = lengths >= min_count
    if only_sym is not None:
        keep &= data[starts] == only_sym
    ks, kl = starts[keep], lengths[keep]
    n_runs = int(ks.shape[0])
    if n_runs + 1 > capacity:
        raise ValueError(f"{n_runs} runs exceed capacity {capacity}")

    sym[:n_runs] = data[ks]
    count[:n_runs] = kl
    prev_end = np.concatenate(([0], (ks + kl)[:-1]))
    lit_len[:n_runs] = ks - prev_end
    last_end = int((ks + kl)[-1]) if n_runs else 0
    lit_len[n_runs] = n - last_end          # tail command (count == 0)
    n_cmds = n_runs + 1

    mask = np.ones(n, bool)
    for s, l in zip(ks, kl):
        mask[s:s + l] = False
    kept = data[mask]
    n_lits = int(kept.shape[0])
    lits[:n_lits] = kept
    return sym, count, lit_len, lits, np.int32(n_cmds), np.int32(n_lits), np.int32(n)


def host_decode_block(sym, count, lit_len, lits, n_cmds, block_len) -> np.ndarray:
    """Golden host decoder for one block (numpy)."""
    out = np.empty(int(block_len), np.uint8)
    pos = 0
    lp = 0
    for c in range(int(n_cmds)):
        ll = int(lit_len[c])
        out[pos:pos + ll] = lits[lp:lp + ll]
        pos += ll
        lp += ll
        cnt = int(count[c])
        out[pos:pos + cnt] = sym[c]
        pos += cnt
    if pos != int(block_len):
        raise ValueError(f"commands cover {pos} bytes, block has "
                         f"{int(block_len)}")
    return out
