"""Low Entropy family: entropy-coder-friendly RLE (+Short, +Single, rle8m).

Byte-exact reimplementation of `rle8_low_entropy_cpu.c` /
`rle8_low_entropy_short_cpu.c`:

- header: ``{u32 compressedLength, u32 uncompressedLength}`` then a 32-byte
  bitset of RLE-enabled symbols, a symbol count (0 encodes "all 256", storing
  255 entries) and the probability-ordered permutation ``symbolsByProb``
  (rle8_low_entropy_cpu.c:441-472).
- body: every original byte is kept; after any RLE-enabled byte one count
  byte ``symbolsByProb[runLength]`` follows (runs capped at 254, Short: 31;
  near the stream end the cap shrinks with the remaining bytes), so the
  output stays entropy-codeable (rle8_low_entropy_cpu.c:474-543).
- info: run-aware histogram with ``pcount += count//cap + 1`` per run and the
  ``pcount[0] = UINT32_MAX`` stream-start quirk; `rle[i]` set when the mean
  run length is >= 2; Single flags only the max-savings symbol (> 2).
- ``rle8m``: N equal subsections sharing one header, u32 table of the first
  N-1 subsections' compressed end offsets, each compressed independently
  (rle8_low_entropy_cpu.c:126-250) — the reference's parallel-decode
  container and the ancestor of our HRT1 block format.
"""

from __future__ import annotations

import struct

import numpy as np

_U32 = struct.Struct("<I")


def compress_bounds(in_size: int) -> int:
    return in_size + 32 + 1 + 256 + 8


def _runs(arr: np.ndarray):
    n = arr.size
    change = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    starts = np.concatenate(([0], change))
    lengths = np.concatenate((change, [n])) - starts
    return starts, lengths, arr[starts]


def _get_info(arr: np.ndarray, cap: int, single: bool):
    """rle8_low_entropy[_short]_get_compress_info[_only_max_frequency]."""
    n = int(arr.size)
    prob = np.zeros(256, np.int64)
    pcount = np.zeros(256, np.int64)

    starts, lengths, syms = _runs(arr)
    np.add.at(prob, syms, lengths)
    contrib = lengths // cap + 1
    # the final run contributes pcount += 1 regardless of its length
    contrib[-1] = 1
    np.add.at(pcount, syms, contrib)
    if int(arr[0]) != 0:
        # pcount[0] starts at UINT32_MAX and the phantom zero-run adds +1
        pcount[0] = (pcount[0] + 0xFFFFFFFF + 1) % (1 << 32)
    pcount %= 1 << 32

    rle = np.zeros(256, bool)
    if single:
        best_saved = 0
        best = 0
        for i in range(256):
            if pcount[i] > 0 and prob[i] // pcount[i] > 2:
                saved = int(prob[i]) - int(pcount[i]) * 2
                if saved > best_saved:
                    best_saved = saved
                    best = i
        if best_saved > 0:
            rle[best] = True
    else:
        nz = pcount > 0
        rle[nz] = (prob[nz] // pcount[nz]) >= 2

    symbols_by_prob = np.zeros(256, np.uint8)
    consumed = np.zeros(256, bool)
    remaining = 256
    for i in range(255, -1, -1):
        if pcount[i] == 0:
            consumed[i] = True
            remaining -= 1
            symbols_by_prob[remaining] = i
    for index in range(remaining):
        mx = 0
        mi = 0
        for i in range(256):
            if not consumed[i] and pcount[i] > mx:
                mx = int(pcount[i])
                mi = i
        symbols_by_prob[index] = mi
        consumed[mi] = True
    return rle, symbols_by_prob, remaining & 0xFF


def _write_info(rle: np.ndarray, sbp: np.ndarray, symbol_count: int) -> bytes:
    out = bytearray(np.packbits(rle, bitorder="little").tobytes())
    out.append(symbol_count)
    sc = symbol_count if symbol_count else 255
    out += sbp[:sc].tobytes()
    return bytes(out)


def _compress_body(arr: np.ndarray, rle: np.ndarray, sbp: np.ndarray,
                   cap: int) -> bytes:
    n = int(arr.size)
    out = bytearray()
    mv = arr.tobytes()
    target = max(n - 256, 0)
    starts, lengths, syms = _runs(arr)
    rle_syms = rle[syms]
    for k in range(starts.size):
        s0 = int(starts[k])
        L = int(lengths[k])
        if not rle_syms[k]:
            out += mv[s0:s0 + L]
            continue
        b = int(syms[k])
        cb = bytes([b])
        pos = s0
        end = s0 + L
        while pos < end:
            rng = cap + 1 if pos < target else min(n - pos - 1, cap + 1)
            avail = end - pos - 1
            count = min(avail, max(rng - 1, 0))
            out += cb
            out.append(int(sbp[count]))
            adv = rng if count == rng - 1 else count + 1
            pos += adv
    return bytes(out)


def _symbol_to_count(sbp_entries: bytes) -> np.ndarray:
    """rle8_low_entropy_read_decompress_info (rle8_low_entropy_cpu.c:545-606)."""
    stc = np.zeros(256, np.uint8)
    listed = np.zeros(256, bool)
    for i, sym in enumerate(sbp_entries):
        stc[sym] = i
        listed[sym] = True
    nxt = len(sbp_entries)
    for i in range(256):
        if not listed[i]:
            stc[i] = nxt & 0xFF
            nxt += 1
    return stc


def le_compress(data, *, short: bool = False, single: bool = False) -> bytes:
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0:
        return b""
    cap = 31 if short else 254
    rle, sbp, sc = _get_info(arr, cap + 1, single)
    out = bytearray(4)
    out += _U32.pack(n)
    out += _write_info(rle, sbp, sc)
    out += _compress_body(arr, rle, sbp, cap)
    _U32.pack_into(out, 0, len(out))
    return bytes(out)


def le_decompress(buf, *, short: bool = False) -> bytes:
    buf = bytes(buf)
    _csize, usize = struct.unpack_from("<II", buf, 0)
    p = 8
    rle = np.unpackbits(np.frombuffer(buf, np.uint8, 32, p),
                        bitorder="little").astype(bool)
    p += 32
    sc = buf[p]; p += 1
    nsym = sc if sc else 255
    stc = _symbol_to_count(buf[p:p + nsym])
    p += nsym

    from ..utils import native
    buf_np = np.empty(usize + 256, np.uint8)
    res = native.le_decode_into(buf, p, rle, stc, buf_np, usize)
    if res is not None:
        return buf_np[:usize].tobytes()

    out = bytearray()
    while len(out) < usize:
        b = buf[p]; p += 1
        out.append(b)
        if rle[b]:
            c = buf[p]; p += 1
            out += bytes([b]) * int(stc[c])
    return bytes(out[:usize])


# ---------------------------------------------------------------------------
# rle8m subsection container (rle8_low_entropy_cpu.c:126-250)
# ---------------------------------------------------------------------------

def rle8m_compress(sub_sections: int, data) -> bytes:
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0 or sub_sections == 0:
        return b""
    rle, sbp, sc = _get_info(arr, 255, single=False)
    out = bytearray(4)
    out += _U32.pack(n)
    out += _U32.pack(sub_sections)
    table_at = len(out)
    out += b"\x00" * (4 * (sub_sections - 1))
    out += _write_info(rle, sbp, sc)
    sub = n // sub_sections
    for i in range(sub_sections - 1):
        out += _compress_body(arr[sub * i:sub * (i + 1)], rle, sbp, 254)
        _U32.pack_into(out, table_at + 4 * i, len(out))
    out += _compress_body(arr[sub * (sub_sections - 1):], rle, sbp, 254)
    _U32.pack_into(out, 0, len(out))
    return bytes(out)


def rle8m_decompress(buf) -> bytes:
    buf = bytes(buf)
    csize, usize = struct.unpack_from("<II", buf, 0)
    p = 8
    subs = _U32.unpack_from(buf, p)[0]; p += 4
    if subs == 0:
        return b""
    offsets = [_U32.unpack_from(buf, p + 4 * i)[0] for i in range(subs - 1)]
    p += 4 * (subs - 1)
    rle = np.unpackbits(np.frombuffer(buf, np.uint8, 32, p),
                        bitorder="little").astype(bool)
    p += 32
    sc = buf[p]; p += 1
    nsym = sc if sc else 255
    stc = _symbol_to_count(buf[p:p + nsym])
    p += nsym

    sub = usize // subs
    bounds = offsets + [csize]
    sizes = [sub] * (subs - 1) + [usize - sub * (subs - 1)]

    from ..utils import native
    if native.lib() is not None and subs < (1 << 20):
        # each section produces >= sizes[k] bytes from the current cursor
        # (a trailing run may overshoot by up to 254; the serial loop keeps
        # the overshoot and the final [:usize] trim discards the excess)
        outn = np.empty(usize + 256 * (subs + 1), np.uint8)
        o, pn, ok = 0, p, True
        for k in range(subs):
            res = native.le_decode_into(buf, pn, rle, stc, outn[o:],
                                        sizes[k])
            if res is None:
                ok = False
                break
            pn, produced = res
            o += produced
            if k < subs - 1:
                pn = bounds[k]
        if ok:
            return outn[:usize].tobytes()

    out = bytearray()
    for k in range(subs):
        want = len(out) + sizes[k]
        while len(out) < want:
            b = buf[p]; p += 1
            out.append(b)
            if rle[b]:
                c = buf[p]; p += 1
                out += bytes([b]) * int(stc[c])
        p = bounds[k] if k < subs - 1 else p
    return bytes(out[:usize])
