"""MMTF 128/256 and Bit-MMTF transforms on the device.

Port of hypersonic_rle_kit_tpu/ops/mmtf_device.py.  MMTF keeps one
256-entry move-to-front history per byte lane (16 lanes for MMTF 128, 32
for MMTF 256) and walks the stream one unit of ``lanes`` bytes at a time
(mmtf.c:112-178 encode, :253-380 decode); a long stream may be split into
independent blocks, each with a fresh history.  The JAX package runs the
serial walk as a ``lax.scan``; a loop of torch ops per unit would be bound
by launches (~65 k steps per MiB at 16 lanes), so on CUDA tensors
``mmtf_scan`` launches the hand-written kernel ``csrc/mmtf.cu`` (one thread
per block and lane), and on CPU tensors it runs the plain version
``mmtf_scan_plain``, the JAX package's step written in torch.

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
        if encode:
            v = units[:, u]
            d = torch.argmax((table == v[..., None]).to(_I32), dim=-1)
        else:
            d = units[:, u]
            v = table.gather(-1, d[..., None])[..., 0]
        shifted = torch.cat([v[..., None], table[..., :-1]], dim=-1)
        table = torch.where(pos <= d[..., None], shifted, table)
        out[:, u] = d if encode else v
    return out.reshape(nb, n), table.to(_I32)


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
    nb, n = x.shape
    out = torch.empty_like(x)
    table = torch.empty((nb, lanes, 256), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernels.lib().mmtf_scan(
            _kernels.ptr(x), _kernels.ptr(out), _kernels.ptr(table), nb, n,
            lanes, int(encode), stream)
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
                   device) -> bytes:
    """Reference-exact MMTF of a byte string of any length, on ``device``.
    The trailing partial unit is looked up in the final histories without
    an update (mmtf.c:161-175)."""
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
