"""Planar columns -> decoded bytes: the wrapper of the hrt1_decode kernel.

Port of hypersonic_rle_kit_tpu/ops/decode_sup.py's entry points
``decode_columns_device``, with the same signature and the same
``out_words`` contract (``[nb, B/4]`` int32 words whose little-endian byte
view is the output), and ``decode_planar_sup`` (host arrays in).  On a
CUDA tensor it launches the hand-written kernel ``csrc/hrt1_decode.cu``; on
a CPU tensor it runs the plain version (``ops/device.decode_blocks``).
The TPU kernel's geometry limits (``fits_kernel``: B a multiple of 1024,
B <= 2^19, <= 512 event columns; the ``MIN_RUN = 4`` rule) do not carry
over: every block size and ``min_count`` the container allows decodes
here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from .device import decode_blocks
from .planar import PlanarBlocks
from .transfer import to_device

MAX_BLOCK = 1 << 28     # keeps the kernel's saturating int32 prefixes exact


def lits_to_words(lits: np.ndarray) -> np.ndarray:
    """Host-side zero-copy reinterpretation of a [nb, L] uint8 literal
    section (L % 4 == 0) as [nb, L/4] little-endian int32 words."""
    if lits.dtype != np.uint8 or lits.shape[1] % 4:
        raise ValueError(f"want uint8 literals of whole words, got "
                         f"{lits.dtype} {lits.shape}")
    return np.ascontiguousarray(lits).view(np.int32)


def words_to_bytes(words: np.ndarray) -> np.ndarray:
    """Host-side zero-copy view of [nb, W] int32 decode output as
    [nb, 4W] bytes."""
    return np.ascontiguousarray(words).view(np.uint8)


def interleave_words(yw: torch.Tensor, *, w: int) -> torch.Tensor:
    """Width re-interleave in the words form: [nb, B/4] int32 words of the
    lane-major (de-interleaved) decode output -> [nb, B/4] words of the
    original byte stream (``out[p] = plane[p % w, p // w]``, bytes
    little-endian in each word), for the ``w % 4 == 0`` widths.  The JAX
    package composes bytes with shifts and masks to avoid a byte relayout
    on the TPU; here the byte view is free, so it is one transpose."""
    nb, W = yw.shape
    B = 4 * W
    if yw.dtype != torch.int32 or w % 4 or B % w:
        raise ValueError(f"interleave_words wants int32 words and w % 4 == "
                         f"0 dividing {B}, got {yw.dtype}, w={w}")
    yb = yw.contiguous().view(torch.uint8)
    return (yb.reshape(nb, w, B // w).transpose(1, 2).contiguous()
            .view(torch.int32).reshape(nb, W))


def _check(sym, count, lit_len, lits, n_cmds, n_lits, block_len,
           block_size: int, out_words: bool) -> None:
    dev = sym.device
    nb, C = sym.shape if sym.dim() == 2 else (-1, -1)
    want = (("sym", sym, (torch.uint8,), (nb, C)),
            ("count", count, (torch.int32,), (nb, C)),
            ("lit_len", lit_len, (torch.int32,), (nb, C)),
            ("lits", lits, (torch.uint8, torch.int32), None),
            ("n_cmds", n_cmds, (torch.int32,), (nb,)),
            ("n_lits", n_lits, (torch.int32,), (nb,)),
            ("block_len", block_len, (torch.int32,), (nb,)))
    for name, t, dtypes, shape in want:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtypes}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb < 0 or C < 1 or lits.dim() != 2 or lits.shape[0] != nb:
        raise ValueError(f"bad column shapes: sym {tuple(sym.shape)}, "
                         f"lits {tuple(lits.shape)}")
    if not 0 < block_size <= MAX_BLOCK:
        raise ValueError(f"block_size {block_size} outside (0, {MAX_BLOCK}]")
    if out_words and block_size % 4:
        raise ValueError(f"out_words needs block_size % 4 == 0, "
                         f"got {block_size}")


def _lit_bytes(lits: torch.Tensor) -> torch.Tensor:
    return lits.view(torch.uint8) if lits.dtype == torch.int32 else lits


def decode_columns_plain(sym, count, lit_len, lits, n_cmds, n_lits,
                         block_len, *, block_size: int,
                         out_words: bool = False) -> torch.Tensor:
    """Plain torch version of the hrt1_decode kernel, on any device."""
    _check(sym, count, lit_len, lits, n_cmds, n_lits, block_len,
           block_size, out_words)
    B = block_size
    lb = _lit_bytes(lits)
    L = lb.shape[1]
    lb = lb[:, :B] if L >= B else torch.nn.functional.pad(lb, (0, B - L))
    out = decode_blocks(PlanarBlocks(sym, count, lit_len, lb, n_cmds,
                                     n_lits, block_len))
    return out.view(torch.int32) if out_words else out


def decode_columns_device(sym, count, lit_len, lits, n_cmds, n_lits,
                          block_len, *, block_size: int,
                          out_words: bool = False) -> torch.Tensor:
    """Planar columns -> decoded [nb, block_size] uint8, or [nb, block_size/4]
    int32 words with ``out_words`` (whose byte view is free: words_to_bytes).

    ``sym`` u8, ``count``/``lit_len`` i32 ``[nb, C]``; ``lits`` either
    ``[nb, L]`` uint8 or ``[nb, L/4]`` int32 words, any L (literals past L
    read as zero); ``n_cmds``/``n_lits``/``block_len`` i32 ``[nb]``.  Output
    past ``block_len`` is zero.  CUDA tensors launch the hrt1_decode kernel,
    CPU tensors take the plain version; anything else raises."""
    dev = sym.device
    if dev.type == "cpu":
        return decode_columns_plain(sym, count, lit_len, lits, n_cmds, n_lits,
                                    block_len, block_size=block_size,
                                    out_words=out_words)
    if dev.type != "cuda":
        raise ValueError(f"hrt1_decode runs on CUDA or CPU tensors, not {dev}")
    _check(sym, count, lit_len, lits, n_cmds, n_lits, block_len,
           block_size, out_words)
    nb, C = sym.shape
    B = block_size
    W = -(-B // 4)
    lb = _lit_bytes(lits)
    L = _kernels.lib()
    scratch = torch.empty(L.hrt1_decode_scratch_ints(nb, C, W),
                          dtype=torch.int32, device=dev)
    # the starts pass's look-back records and work ticket, zeroed
    state = torch.zeros(L.hrt1_decode_state_ints(nb, C), dtype=torch.int32,
                        device=dev)
    out = torch.empty((nb, W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.hrt1_decode(
            _kernels.ptr(sym), _kernels.ptr(count), _kernels.ptr(lit_len),
            _kernels.ptr(lb), _kernels.ptr(n_cmds), _kernels.ptr(block_len),
            _kernels.ptr(scratch), _kernels.ptr(state), _kernels.ptr(out),
            nb, C, lb.shape[1], B, W, stream)
    _kernels.check(rc, "hrt1_decode")
    _kernels.count_launch("hrt1_decode")
    if out_words:
        return out
    ob = out.view(torch.uint8)
    return ob if 4 * W == B else ob[:, :B].contiguous()


def columns_to_device(cols, device) -> list[torch.Tensor]:
    """Numpy planar columns -> tensors on ``device``, each column through a
    pinned buffer."""
    dev = torch.device(device)
    return [to_device(np.ascontiguousarray(c), dev) for c in cols]


def decode_host_columns(cols, *, block_size: int,
                        device="cuda") -> torch.Tensor:
    """Numpy planar columns ``(sym, count, lit_len, lits, n_cmds, n_lits,
    block_len)`` -> decoded ``[nb, block_size]`` uint8 on ``device``:
    :func:`columns_to_device`, then :func:`decode_columns_device`."""
    return decode_columns_device(*columns_to_device(cols, device),
                                 block_size=block_size)


def decode_planar_sup(sym, count, lit_len, lits, n_cmds, n_lits, block_len,
                      *, block_size: int, device="cuda") -> torch.Tensor:
    """Host-array convenience wrapper around the device entry point, as in
    the JAX package: array-likes cast to the columns' dtypes, then
    :func:`decode_host_columns` on ``device``."""
    cols = [np.asarray(a, t) for a, t in (
        (sym, np.uint8), (count, np.int32), (lit_len, np.int32),
        (lits, np.uint8), (n_cmds, np.int32), (n_lits, np.int32),
        (block_len, np.int32))]
    return decode_host_columns(cols, block_size=block_size, device=device)
