"""Bytes -> planar columns: the wrapper of the hrt1_encode kernel.

Port of hypersonic_rle_kit_tpu/ops/encode_sup.py's entry point
``encode_blocks_kernel`` with the same signature and outputs.  On a CUDA
tensor it launches the hand-written kernel ``csrc/hrt1_encode.cu``; on a CPU
tensor it runs the plain version (``ops/device.encode_blocks``).  The TPU
kernel's geometry limits (B and capacity multiples of 128, capacity rows
<= block rows, G-block grouping) do not carry over: every block size the
container allows and every ``min_count >= 1`` encodes here.
"""

from __future__ import annotations

import torch

from . import _kernels
from .decode_sup import MAX_BLOCK
from .device import encode_blocks

_I32 = torch.int32


def _check(x, block_len, only_sym, capacity: int, min_count: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"x must be a [nb, B] tensor, got {type(x)}")
    dev = x.device
    nb, B = x.shape
    want = [("x", x, torch.uint8, (nb, B)),
            ("block_len", block_len, _I32, (nb,))]
    if only_sym is not None:
        want.append(("only_sym", only_sym, _I32, (nb,)))
    for name, t, dtype, shape in want:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb < 1 or not 0 < B <= MAX_BLOCK:
        raise ValueError(f"want nb >= 1 and 0 < B <= {MAX_BLOCK}, got "
                         f"{tuple(x.shape)}")
    if capacity < 1 or min_count < 1:
        raise ValueError(f"want capacity >= 1 and min_count >= 1, got "
                         f"{capacity}, {min_count}")


def _launch(x, block_len, only_sym, capacity: int, min_count: int):
    """One hrt1_encode launch on CUDA tensors (checked by the caller); no
    synchronisation.  Returns the six columns; n_cmds may exceed
    ``capacity``, and then only the first ``capacity`` commands are set."""
    dev = x.device
    nb, B = x.shape
    sym = torch.empty((nb, capacity), dtype=torch.uint8, device=dev)
    count = torch.empty((nb, capacity), dtype=_I32, device=dev)
    lit_len = torch.empty((nb, capacity), dtype=_I32, device=dev)
    lits = torch.empty((nb, B), dtype=torch.uint8, device=dev)
    n_cmds = torch.empty(nb, dtype=_I32, device=dev)
    n_lits = torch.empty(nb, dtype=_I32, device=dev)
    L = _kernels.lib()
    # the tiles' look-back records and the work ticket, zeroed
    state = torch.zeros(L.hrt1_encode_state_ints(nb, B), dtype=_I32,
                        device=dev)
    vec = int(B % 16 == 0 and x.data_ptr() % 16 == 0)
    p = _kernels.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.hrt1_encode(
            p(x), p(block_len), None if only_sym is None else p(only_sym),
            p(sym), p(count), p(lit_len), p(lits), p(n_cmds), p(n_lits),
            p(state), nb, B, capacity, min_count, vec, stream)
    _kernels.check(rc, "hrt1_encode")
    _kernels.count_launch("hrt1_encode")
    return sym, count, lit_len, lits, n_cmds, n_lits


def encode_blocks_launch(x: torch.Tensor, block_len: torch.Tensor, *,
                         capacity: int, min_count: int = 6,
                         only_sym: torch.Tensor | None = None):
    """The first half of :func:`encode_blocks_kernel`, which reads nothing
    back: returns ``(columns, probe)``.  On a CUDA tensor it launches the
    kernel and returns at once; ``probe`` is a ``[2]`` int32 tensor on the
    card (the most commands of a block, the count of bad lengths) for
    :func:`check_encoded`, so a caller driving several cards launches on
    each before it reads any.  On a CPU tensor it runs the plain version,
    raises its ValueErrors at once and returns ``probe`` None."""
    _check(x, block_len, only_sym, capacity, min_count)
    B = x.shape[1]
    bad_len = (block_len < 0) | (block_len > B)
    dev = x.device
    if dev.type == "cpu":
        if bool(bad_len.any()):
            raise ValueError(f"block_len outside [0, {B}]")
        pb = encode_blocks(x, block_len, capacity=capacity,
                           min_count=min_count, only_sym=only_sym)
        # contiguous like the kernel's outputs, so they feed hrt1_decode
        return tuple(c.contiguous() for c in (pb.sym, pb.count, pb.lit_len,
                                              pb.lits, pb.n_cmds,
                                              pb.n_lits)), None
    if dev.type != "cuda":
        raise ValueError(f"hrt1_encode runs on CUDA or CPU tensors, not {dev}")
    cols = _launch(x, block_len, only_sym, capacity, min_count)
    # the kernel clamps block_len, so its range is checked here
    return cols, torch.stack([cols[4].max(), bad_len.sum(dtype=_I32)])


def check_encoded(probes, *, capacity: int, block_size: int) -> None:
    """The second half of :func:`encode_blocks_kernel`: one host read of
    every launch's probe (None for the CPU's, already checked), gathered
    on the first probe's card.  Raises ValueError where a block length
    was outside ``[0, block_size]`` or a block needed more than
    ``capacity`` commands."""
    probes = [p for p in probes if p is not None]
    if not probes:
        return
    dev = probes[0].device
    for most, n_bad in torch.stack([p.to(dev, non_blocking=True)
                                    for p in probes]).tolist():
        if n_bad:
            raise ValueError(f"block_len outside [0, {block_size}]")
        if most > capacity:
            raise ValueError(f"{most - 1} runs exceed capacity {capacity}")


def encode_blocks_kernel(x: torch.Tensor, block_len: torch.Tensor, *,
                         capacity: int, min_count: int = 6,
                         only_sym: torch.Tensor | None = None):
    """Encode ``[nb, B]`` uint8 blocks into planar columns.

    ``block_len`` i32 ``[nb]`` (each in ``[0, B]``) gives the valid bytes of
    each block; ``only_sym`` i32 ``[nb]`` (or None) restricts emission per
    block to runs of that byte (Single; a negative entry lifts it).  Returns
    ``(sym u8, count i32, lit_len i32 [nb, capacity], lits u8 [nb, B],
    n_cmds i32 [nb], n_lits i32 [nb])``, zero past ``n_cmds`` / ``n_lits``.
    Raises ValueError when a block needs more than ``capacity`` commands.
    CUDA tensors launch the hrt1_encode kernel (one synchronisation for
    the checks), CPU tensors take the plain version; anything else
    raises."""
    cols, probe = encode_blocks_launch(x, block_len, capacity=capacity,
                                       min_count=min_count,
                                       only_sym=only_sym)
    check_encoded([probe], capacity=capacity, block_size=x.shape[1])
    return cols
