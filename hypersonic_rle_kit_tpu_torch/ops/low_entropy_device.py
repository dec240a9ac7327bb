"""Device decode of the Low Entropy / ``rle8m`` formats.

Port of hypersonic_rle_kit_tpu/ops/low_entropy_device.py (:102-161), the
analog of the reference's only accelerator backend, its OpenCL decoder
(rle8_ocl.c:265-413): the host parses the container and walks each
subsection's command stream once (O(compressed)), lowering it to planar
columns; the card expands every subsection at once, one block per
subsection, with the hrt1_decode kernel (the JAX package uses the XLA
block decoder here; the bytes are the same).

The JAX module imports jax at its top, so the host walker is carried here
as a copy, with the same ValueErrors.  A subsection longer than
``decode_sup.MAX_BLOCK`` (256 MiB) raises ValueError in the decoder.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..formats.low_entropy import _symbol_to_count
from . import decode_sup
from .transfer import to_host

_ROW = 128


def _parse_section_to_planar(buf: memoryview, p: int, want: int,
                             rle: np.ndarray, stc: np.ndarray):
    """Walk one subsection's compressed stream; return (sym, count, lit_len,
    lits, n_cmds, n_lits, next_p).  Every compressed byte is a literal; an
    RLE-enabled byte is additionally followed by one count byte
    (rle8_ocl_kernel.h:9-45 is the scalar dual of this)."""
    sym, count, lit_len = [], [], []
    lits = bytearray()
    lit_run = 0
    produced = 0
    end = len(buf)
    while produced < want:
        if p >= end:
            raise ValueError("low-entropy stream truncated mid-subsection")
        b = buf[p]; p += 1
        lits.append(b)
        lit_run += 1
        produced += 1
        if rle[b]:
            if p >= end:
                raise ValueError("low-entropy stream truncated at count byte")
            c = int(stc[buf[p]]); p += 1
            if c:
                sym.append(b)
                count.append(c)
                lit_len.append(lit_run)
                lit_run = 0
                produced += c
    if produced != want:
        # a run crossed the subsection boundary: the host decoder carries the
        # overshoot into the next subsection; here it means the stream does
        # not decompose into independent blocks, so fail loudly.
        raise ValueError(
            f"subsection overshoot: produced {produced}, wanted {want}")
    sym.append(0)
    count.append(0)
    lit_len.append(lit_run)          # tail command (count == 0)
    return (np.array(sym, np.uint8), np.array(count, np.int32),
            np.array(lit_len, np.int32), np.frombuffer(bytes(lits), np.uint8),
            len(sym), len(lits), p)


def _stack_planar(parts, block_lens):
    """Per-section planar columns -> numpy columns padded to a common
    shape, and the block size (the longest section, rounded up to 128)."""
    nb = len(parts)
    cap = -(-max(p[4] for p in parts) // _ROW) * _ROW
    lcap = max(_ROW, -(-max(p[5] for p in parts) // _ROW) * _ROW)
    B = -(-max(int(n) for n in block_lens) // _ROW) * _ROW
    sym = np.zeros((nb, cap), np.uint8)
    count = np.zeros((nb, cap), np.int32)
    lit_len = np.zeros((nb, cap), np.int32)
    lits = np.zeros((nb, lcap), np.uint8)
    n_cmds = np.zeros(nb, np.int32)
    n_lits = np.zeros(nb, np.int32)
    for i, (s, c, ll, lb, nc, nl, _) in enumerate(parts):
        sym[i, :nc] = s
        count[i, :nc] = c
        lit_len[i, :nc] = ll
        lits[i, :nl] = lb
        n_cmds[i] = nc
        n_lits[i] = nl
    cols = (sym, count, lit_len, lits, n_cmds, n_lits,
            np.asarray(block_lens, np.int32))
    return cols, B


def _header(buf: memoryview, p: int):
    """The RLE bitset and count table after offset ``p``; returns (rle,
    symbol-to-count, next p)."""
    rle = np.unpackbits(np.frombuffer(buf, np.uint8, 32, p),
                        bitorder="little").astype(bool)
    p += 32
    sc = buf[p]; p += 1
    nsym = sc if sc else 255
    stc = _symbol_to_count(bytes(buf[p:p + nsym]))
    return rle, stc, p + nsym


def walk_le(buf) -> tuple:
    """Host half of :func:`le_decompress_device`: ``(cols, B, sizes)`` as
    :func:`walk_rle8m` gives them, one block; cols None and sizes empty for
    an empty stream."""
    buf = memoryview(bytes(buf))
    _csize, usize = struct.unpack_from("<II", buf, 0)
    if usize == 0:
        return None, 0, []
    rle, stc, p = _header(buf, 8)
    part = _parse_section_to_planar(buf, p, usize, rle, stc)
    cols, B = _stack_planar([part], [usize])
    return cols, B, [usize]


def join(y: torch.Tensor, sizes) -> torch.Tensor:
    """Decoded ``[nb, B]`` blocks -> the output bytes on ``y``'s device:
    every block but the last holds ``sizes[0]`` bytes, the last
    ``sizes[-1]``."""
    if len(sizes) == 1:
        return y[0, :sizes[0]]
    return torch.cat([y[:-1, :sizes[0]].reshape(-1), y[-1, :sizes[-1]]])


def _decode(walked, device) -> bytes:
    cols, B, sizes = walked
    if not sizes:
        return b""
    y = decode_sup.decode_host_columns(cols, block_size=B, device=device)
    (out,) = to_host(join(y, sizes))
    return out.tobytes()


def le_decompress_device(buf, *, device) -> bytes:
    """Decode a Low Entropy (+Short: same grammar) stream on ``device``
    ('cuda', 'cuda:N' or 'cpu'; CUDA runs the hrt1_decode kernel, CPU its
    plain version)."""
    return _decode(walk_le(buf), device)


def walk_rle8m(buf) -> tuple:
    """Host half of :func:`rle8m_decompress_device`: ``(cols, B, sizes)``,
    cols None for an empty container."""
    buf = memoryview(bytes(buf))
    _csize, usize = struct.unpack_from("<II", buf, 0)
    p = 8
    subs = struct.unpack_from("<I", buf, p)[0]; p += 4
    if subs == 0 or usize == 0:
        return None, 0, []
    # per-subsection end offsets are authoritative (rle8_ocl.c pStartOffsets;
    # host rle8m_decompress re-anchors the same way)
    offsets = [struct.unpack_from("<I", buf, p + 4 * i)[0]
               for i in range(subs - 1)]
    p += 4 * (subs - 1)
    rle, stc, p = _header(buf, p)

    sub = usize // subs
    sizes = [sub] * (subs - 1) + [usize - sub * (subs - 1)]
    bounds = offsets + [_csize]
    parts = []
    for k, want in enumerate(sizes):
        part = _parse_section_to_planar(buf, p, want, rle, stc)
        p = part[-1]
        if p > bounds[k]:
            raise ValueError(
                f"subsection {k} parse ran past its recorded offset "
                f"({p} > {bounds[k]})")
        p = bounds[k]                 # re-anchor to the recorded offset
        parts.append(part)
    cols, B = _stack_planar(parts, sizes)
    return cols, B, sizes


def rle8m_decompress_device(buf, *, device) -> bytes:
    """Decode an ``rle8m`` container on ``device``, one block per
    subsection: the analog of ``rle8m_opencl_decompress``
    (rle8_ocl.c:265-413) with the NDRange replaced by the block axis.  The
    subsections are joined on the device and come back in one copy."""
    return _decode(walk_rle8m(buf), device)
