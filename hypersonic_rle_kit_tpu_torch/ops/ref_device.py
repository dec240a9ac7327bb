"""Device decode of reference-format streams (rle8 / rleX / rle128 / LUT /
Short families).

Port of hypersonic_rle_kit_tpu/ops/ref_device.py's ``decompress_ref_device``
(:499-572).  The host walks the stream's command grammar once
(O(compressed), no expansion) and lowers it to planar columns split into
fixed-size blocks; the card expands every block at once with the
hrt1_decode kernel.  A run of an s-byte symbol (width > 8) is, in each of
the s phases (output positions with the same index mod s), a plain byte
run, so the walk emits s phase streams and the card re-interleaves them
with one transpose.

The host half is the native walk ``native.ref_parse_planar`` and, where
the library is missing, the Python walkers and ``parse_to_planar`` of
``ops/ref_walk.py`` (the port's copies of the JAX package's).  What the JAX package has
only for its TPU kernel's limits is gone: the ``min_run >= 4`` and
``fits_kernel`` gate, the swallow-all ``except`` and the XLA fallback.
hrt1_decode takes every block size and run length, so the packed grammars
(MIN_RANGE 3) decode through the kernel too, and a kernel error
propagates.
"""

from __future__ import annotations

import torch

from .. import spec as spec_mod
from ..utils import native
from . import decode_sup, ref_walk as host_walk
from .transfer import to_host

DEFAULT_BLOCK = host_walk.DEFAULT_BLOCK
parse_to_planar = host_walk.parse_to_planar
_ROW = 128


def codec_spec(codec) -> "spec_mod.CodecSpec":
    """A CodecSpec, its registry index or its name -> the CodecSpec."""
    if isinstance(codec, spec_mod.CodecSpec):
        return codec
    if isinstance(codec, int):
        return spec_mod.by_index(codec)
    return spec_mod.by_name(codec)


def walk(buf: bytes, cspec, block_size: int = DEFAULT_BLOCK):
    """Host half: the grammar walk.  Returns ``(cols, usize, s, B)``: the
    numpy planar columns of the phase-major blocks of ``B`` bytes (None
    when ``usize == 0``), the decoded size and the symbol width in bytes.
    The block size is the JAX package's rule (a multiple of 1024 for short
    streams), so the columns equal its columns."""
    it, usize, s = host_walk._iter_for(cspec, buf)
    if usize == 0:
        return None, 0, s, 0
    m = -(-usize // s)
    B = min(block_size, max(8 * _ROW, -(-m // (8 * _ROW)) * 8 * _ROW))
    cols = None
    fam, fl = host_walk._native_args(cspec)
    if fam is not None:
        res = native.ref_parse_planar(buf, fam, cspec.width or 8, fl,
                                      cspec.lut or 0, usize, B)
        cols = None if res is None else res[0]
    if cols is None:                    # no library, or its walk failed
        _, cols = parse_to_planar(buf, it, usize, s, B)
    return cols, usize, s, B


def interleave(y: torch.Tensor, *, s: int, m: int) -> torch.Tensor:
    """Decoded ``[s * blocks per phase, B]`` phase-major blocks -> the byte stream on
    ``y``'s device (``m = ceil(usize / s)`` bytes per phase)."""
    if s == 1:
        return y.reshape(-1)
    return y.reshape(s, -1)[:, :m].t().contiguous().reshape(-1)


def finish(y: torch.Tensor, usize: int, s: int) -> torch.Tensor:
    """Decoded blocks -> the ``usize`` output bytes on ``y``'s device."""
    return interleave(y, s=s, m=-(-usize // s))[:usize]


def decompress_ref_device(buf, codec, *, block_size: int = DEFAULT_BLOCK,
                          device="cuda") -> bytes:
    """Decode a reference-format stream on ``device`` ('cuda', the default,
    'cuda:N' or 'cpu'; CUDA runs the hrt1_decode kernel, CPU its plain
    version).

    The host walks the grammar once; the columns cross through pinned
    buffers; the kernel expands all blocks; the width re-interleave runs
    on the device; one copy brings the bytes back."""
    buf = bytes(buf)
    cols, usize, s, B = walk(buf, codec_spec(codec), block_size)
    if usize == 0:
        return b""
    y = decode_sup.decode_host_columns(cols, block_size=B, device=device)
    (out,) = to_host(finish(y, usize, s))
    return out.tobytes()
