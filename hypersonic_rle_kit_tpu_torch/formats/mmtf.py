"""Multi-Move-To-Front transforms (ratio 1.0): MMTF 128/256 and Bit-MMTF 8/16.

- ``mmtf{128,256}`` (mmtf.c): 16 (or 32) independent byte-lane MTF-of-256
  transforms.  Lane L processes bytes L, L+16, L+32, ... with its own
  256-entry move-to-front history initialized 0..255 (mmtf.c:115-158); the
  trailing partial block is looked up in the history without updating it
  (mmtf.c:161-175).
- ``bitmmtf{8,16}`` (bit_mmtf.c): per-bit-position change predictor — the
  encode is the XOR delta of consecutive bytes (u16 units for bitmmtf16, odd
  tail byte copied verbatim), the decode the prefix-XOR.
"""

from __future__ import annotations

import numpy as np


def _mtf_encode_lane(seq: np.ndarray) -> np.ndarray:
    hist = list(range(256))
    out = np.empty(seq.shape[0], np.uint8)
    idx = hist.index
    for k, v in enumerate(seq.tolist()):
        d = idx(v)
        out[k] = d
        if d:
            del hist[d]
            hist.insert(0, v)
    return out, hist


def _mtf_decode_lane(seq: np.ndarray) -> np.ndarray:
    hist = list(range(256))
    out = np.empty(seq.shape[0], np.uint8)
    for k, d in enumerate(seq.tolist()):
        v = hist[d]
        out[k] = v
        if d:
            del hist[d]
            hist.insert(0, v)
    return out, hist


def _mmtf(data, lanes: int, encode: bool) -> bytes:
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0:
        return b""
    from ..utils import native
    fast = native.mmtf(arr.tobytes(), lanes, encode)
    if fast is not None:
        return fast
    full = n // lanes * lanes
    out = np.empty(n, np.uint8)
    hists = []
    for lane in range(lanes):
        seq = arr[lane:full:lanes]
        if encode:
            res, hist = _mtf_encode_lane(seq)
        else:
            res, hist = _mtf_decode_lane(seq)
        out[lane:full:lanes] = res
        hists.append(hist)
    # trailing partial block: history lookup without MTF update
    for i in range(full, n):
        lane = i - full
        if encode:
            out[i] = hists[lane].index(int(arr[i]))
        else:
            out[i] = hists[lane][int(arr[i])]
    return out.tobytes()


def mmtf128_encode(data) -> bytes:
    return _mmtf(data, 16, encode=True)


def mmtf128_decode(data) -> bytes:
    return _mmtf(data, 16, encode=False)


def mmtf256_encode(data) -> bytes:
    return _mmtf(data, 32, encode=True)


def mmtf256_decode(data) -> bytes:
    return _mmtf(data, 32, encode=False)


def _as_arr(data) -> np.ndarray:
    return (np.frombuffer(memoryview(data), dtype=np.uint8)
            if not isinstance(data, np.ndarray)
            else np.ascontiguousarray(data, dtype=np.uint8))


def bitmmtf8_encode(data) -> bytes:
    arr = _as_arr(data)
    if arr.size == 0:
        return b""
    prev = np.concatenate((np.zeros(1, np.uint8), arr[:-1]))
    return np.bitwise_xor(arr, prev).tobytes()


def bitmmtf8_decode(data) -> bytes:
    arr = _as_arr(data)
    if arr.size == 0:
        return b""
    return np.bitwise_xor.accumulate(arr).astype(np.uint8).tobytes()


def bitmmtf16_encode(data) -> bytes:
    arr = _as_arr(data)
    n = int(arr.size)
    if n == 0:
        return b""
    full = n & ~1
    v = arr[:full].view("<u2")
    prev = np.concatenate((np.zeros(1, "<u2"), v[:-1]))
    out = np.empty(n, np.uint8)
    out[:full] = np.bitwise_xor(v, prev).view(np.uint8)
    if n & 1:
        out[-1] = arr[-1]
    return out.tobytes()


def bitmmtf16_decode(data) -> bytes:
    arr = _as_arr(data)
    n = int(arr.size)
    if n == 0:
        return b""
    full = n & ~1
    v = arr[:full].view("<u2")
    out = np.empty(n, np.uint8)
    out[:full] = np.bitwise_xor.accumulate(v).astype("<u2").view(np.uint8)
    if n & 1:
        out[-1] = arr[-1]
    return out.tobytes()
