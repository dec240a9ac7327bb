"""MMTF 128/256 and Bit-MMTF transforms on the device.

Port of hypersonic_rle_kit_tpu/ops/mmtf_device.py.  MMTF keeps one
256-entry move-to-front history per byte lane (16 lanes for MMTF 128, 32
for MMTF 256) and walks the stream one unit of ``lanes`` bytes at a time
(mmtf.c:112-178 encode, :253-380 decode); a long stream may be split into
independent blocks, each with a fresh history.  The JAX package runs the
serial walk as a ``lax.scan``; a loop of torch ops per unit would be bound
by launches (~65 k steps per MiB at 16 lanes), so on CUDA tensors
``mmtf_scan`` launches the hand-written kernel ``csrc/mmtf.cu``, and on CPU
tensors it runs the plain version ``mmtf_scan_plain``, the JAX package's
step written in torch.  The kernel cuts each lane's chain into chunks of
``CHUNK`` units whose serial passes start from the identity history, then
composes the chunks' effects and fixes the outputs up;
``mmtf_scan_chunked_plain`` carries out the same three phases in torch, so
the CPU tests can hold that algebra against the JAX scan.

Bit-MMTF (bit_mmtf.c:18-128) is the XOR delta of consecutive 1- or 2-byte
units; its decode is a prefix XOR, here the parity of a per-bit cumulative
sum (torch has no cumulative XOR).

``mmtf_transform`` is reference-exact on a byte string of any length: the
trailing partial unit is a history lookup without an update
(mmtf.c:161-175), taken from the scan's final table on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

_I32 = torch.int32
_U8 = torch.uint8
_I64 = torch.int64
CHUNK = 512          # units per chunk of the kernel's serial passes
MAX_CHUNK = 1024     # the kernel stages CHUNK x 32 lanes bytes per CTA


def _check(x: torch.Tensor, lanes: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"want a [nb, n] tensor, got {type(x)}")
    if x.dtype != _U8:
        raise TypeError(f"x: dtype {x.dtype}, want {_U8}")
    if lanes < 1 or x.shape[1] % lanes:
        raise ValueError(f"n = {x.shape[1]} is not a multiple of {lanes} lanes")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def mmtf_scan_plain(x: torch.Tensor, *, lanes: int, encode: bool):
    """Plain torch version of the mmtf_scan kernel: one step of torch ops
    per unit, as the JAX package's ``_mtf_step``.  Returns ``(out u8
    [nb, n], table i32 [nb, lanes, 256])``, the final histories."""
    _check(x, lanes)
    nb, n = x.shape
    dev = x.device
    units = x.reshape(nb, n // lanes, lanes).long()
    pos = torch.arange(256, device=dev)
    table = pos.expand(nb, lanes, 256).clone()
    out = torch.empty((nb, n // lanes, lanes), dtype=_U8, device=dev)
    for u in range(units.shape[1]):
        table, d, v = _step(table, pos, units[:, u], encode)
        out[:, u] = d if encode else v
    return out.reshape(nb, n), table.to(_I32)


def _step(h: torch.Tensor, pos: torch.Tensor, col: torch.Tensor,
          encode: bool):
    """One move-to-front step of histories ``h[..., 256]`` on the symbols
    (encode) or positions (decode) ``col[...]``: ``(h', d, v)``; ``pos``
    is ``arange(256)`` on h's device."""
    if encode:
        v = col
        d = torch.argmax((h == v[..., None]).to(_I32), dim=-1)
    else:
        d = col
        v = h.gather(-1, d[..., None])[..., 0]
    shifted = torch.cat([v[..., None], h[..., :-1]], dim=-1)
    return torch.where(pos <= d[..., None], shifted, h), d, v


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """Each permutation's inverse along the last axis."""
    pos = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, pos)


def mmtf_scan_chunked_plain(x: torch.Tensor, *, lanes: int, encode: bool,
                            chunk: int):
    """The mmtf_scan kernel's decomposition, literally, in torch: the same
    ``(out, table)`` as :func:`mmtf_scan_plain`, computed in three phases
    over chunks of ``chunk`` units per (block, lane).  Used by the tests,
    which hold the algebra the kernel relies on against the JAX scan.

    1. Each chunk runs from the identity history.  Decode outputs are slots
       of the chunk's start history, its final history the slot
       permutation P_k; encode ranks of repeated symbols are already right,
       and the chunk's first occurrences are marked (a symbol is new iff it
       sits past the nd symbols seen so far).
    2. The start histories: H_0 = identity, decode H_{k+1} = H_k[P_k],
       encode H_{k+1} = L_k ++ (H_k without L_k), L_k the final history's
       first nd entries.
    3. Decode out = H_k[slot]; the j-th first occurrence of encode, of
       symbol v, gets j + #{t ahead of v in H_k, t not among the chunk's
       first j first occurrences}."""
    _check(x, lanes)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    nb, n = x.shape
    dev = x.device
    units = n // lanes
    u = x.reshape(nb, units, lanes).transpose(1, 2).long()   # [nb, lanes, U]
    pos = torch.arange(256, device=dev)
    ident = pos.expand(nb, lanes, 256)
    out = torch.empty_like(u)
    chunks = []
    for lo in range(0, units, chunk):            # 1. identity passes
        hi = min(lo + chunk, units)
        h = ident
        nd = torch.zeros((nb, lanes), dtype=_I64, device=dev)
        first = torch.zeros((nb, lanes, hi - lo), dtype=torch.bool,
                            device=dev)
        for i in range(lo, hi):
            h, d, v = _step(h, pos, u[..., i], encode)
            if encode:
                first[..., i - lo] = d >= nd
                nd = nd + first[..., i - lo]
            out[..., i] = d if encode else v
        chunks.append((lo, hi, h, nd, first))
    hk, starts = ident, []
    for _, _, fin, nd, _ in chunks:              # 2. chunk effects in order
        starts.append(hk)
        if encode:
            in_l = _inverse(fin).gather(-1, hk) < nd[..., None]
            kept = hk.gather(-1, torch.argsort(in_l.to(torch.int16), dim=-1,
                                               stable=True))
            behind = kept.gather(-1, (pos - nd[..., None]).clamp(min=0))
            hk = torch.where(pos < nd[..., None], fin, behind)
        else:
            hk = hk.gather(-1, fin)
    for (lo, hi, _, _, first), h0 in zip(chunks, starts):   # 3. fix-up
        seg = out[..., lo:hi]
        if encode:
            p = _inverse(h0).gather(-1, u[..., lo:hi])
            j = torch.cumsum(first, -1) - first.long()
            m = hi - lo
            earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
            below = (earlier & first[..., None, :]
                     & (p[..., None, :] < p[..., :, None])).sum(-1)
            out[..., lo:hi] = torch.where(first, j + p - below, seg)
        else:
            out[..., lo:hi] = h0.gather(-1, seg)
    return (out.transpose(1, 2).reshape(nb, n).to(_U8),
            hk.to(_I32).contiguous())


def mmtf_scan(x: torch.Tensor, *, lanes: int, encode: bool):
    """MMTF of ``x[nb, n]`` bytes (n a multiple of ``lanes``), independent
    per block: ``(out u8 [nb, n], table i32 [nb, lanes, 256])`` with each
    (block, lane)'s final history.  CUDA tensors launch the mmtf_scan
    kernel, CPU tensors take :func:`mmtf_scan_plain`; anything else
    raises."""
    _check(x, lanes)
    dev = x.device
    if dev.type == "cpu":
        return mmtf_scan_plain(x, lanes=lanes, encode=encode)
    if dev.type != "cuda":
        raise ValueError(f"mmtf_scan runs on CUDA or CPU tensors, not {dev}")
    return _launch(x, lanes, encode, CHUNK)


def _launch(x: torch.Tensor, lanes: int, encode: bool, chunk: int):
    """Launch the mmtf_scan kernel on a checked CUDA tensor with chunks of
    ``chunk`` units (1..MAX_CHUNK)."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    nb, n = x.shape
    dev = x.device
    L = _kernels.lib()
    out = torch.empty_like(x)
    table = torch.empty((nb, lanes, 256), dtype=_I32, device=dev)
    scratch = torch.empty(
        L.mmtf_scan_scratch_ints(nb, n, lanes, int(encode), chunk),
        dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.mmtf_scan(_kernels.ptr(x), _kernels.ptr(out),
                         _kernels.ptr(table), _kernels.ptr(scratch), nb, n,
                         lanes, int(encode), chunk, stream)
    _kernels.check(rc, "mmtf_scan")
    _kernels.count_launch("mmtf_scan")
    return out, table


def mmtf_device(x: torch.Tensor, *, lanes: int = 16,
                encode: bool = True) -> torch.Tensor:
    """MMTF transform of ``x[nb, n]`` bytes (n divisible by ``lanes``),
    independent per block.  ``lanes=16`` is MMTF 128, ``lanes=32`` MMTF
    256."""
    return mmtf_scan(x, lanes=lanes, encode=encode)[0]


def mmtf128_device(x, *, encode=True):
    return mmtf_device(x, lanes=16, encode=encode)


def mmtf256_device(x, *, encode=True):
    return mmtf_device(x, lanes=32, encode=encode)


def _units(x: torch.Tensor, unit: int) -> torch.Tensor:
    nb, n = x.shape
    if unit < 1 or n % unit:
        raise ValueError(f"want a unit >= 1 dividing n = {n}, got {unit}")
    return x.reshape(nb, n // unit, unit)


def bitmmtf_encode_device(x: torch.Tensor, *, unit: int = 1) -> torch.Tensor:
    """XOR delta of consecutive ``unit``-byte units of ``x[nb, n]``
    (n divisible by ``unit``); per-block independent (first unit kept)."""
    v = _units(x, unit)
    out = v.clone()
    out[:, 1:] ^= v[:, :-1]
    return out.reshape(x.shape)


def bitmmtf_decode_device(x: torch.Tensor, *, unit: int = 1) -> torch.Tensor:
    """Prefix XOR over units: bit k of the output is the parity of the
    cumulative count of bit k."""
    v = _units(x, unit)
    out = torch.zeros_like(v)
    for k in range(8):
        ones = torch.cumsum((v >> k) & 1, dim=1, dtype=_I32)
        out |= ((ones & 1) << k).to(_U8)
    return out.reshape(x.shape)


def mmtf_transform(data, *, lanes: int = 16, encode: bool = True,
                   device="cuda") -> bytes:
    """Reference-exact MMTF of a byte string of any length, on ``device``
    (the card unless the caller asks for 'cpu').  The trailing partial
    unit is looked up in the final histories without an update
    (mmtf.c:161-175)."""
    arr = np.frombuffer(memoryview(bytes(data)), np.uint8)
    n = arr.size
    if n == 0:
        return b""
    dev = torch.device(device)
    full = n // lanes * lanes
    x = torch.from_numpy(arr.copy()).to(dev)
    out, table = mmtf_scan(x[None, :full], lanes=lanes, encode=encode)
    tail = x[full:].long()
    hist = table[0, :n - full].long()                # [tail lanes, 256]
    if encode:
        t = torch.argmax((hist == tail[:, None]).to(_I32), dim=1)
    else:
        t = hist.gather(1, tail[:, None])[:, 0]
    res = torch.cat([out[0], t.to(_U8)])
    return res.cpu().numpy().tobytes()
