"""128-bit symbol RLE family (rle128_extreme_cpu.{c,h}).

Symbols are full 16-byte vectors; equality is whole-vector
(``movemask(cmpeq) == 0xFFFF``, rle128_extreme_cpu.h:66-98).  Variants:
Symbol/Byte x plain/Packed; Byte+Packed uses the 7-bit shifted copy-range
(PREFER_7_BIT_OR_4_BYTE_COPY), Symbol+Packed the plain u8/u32 escape
(rle128_extreme_cpu.c:14-34 instantiation order).

The encoder below is a step-accurate transliteration of the reference's
single SSE implementation — including its data-dependent skip-ahead strides
(rle128_extreme_cpu.h:233-266), the scalar fallback that reloads ``symbol``
at every failed step (and can then re-match a *phase-shifted* stale symbol in
the match loop), and guarded reads into the zero-initialized buffer slack.
Only the full-vector match loop is fast-forwarded (provably equivalent runs).
"""

from __future__ import annotations

import struct

import numpy as np

_U32 = struct.Struct("<I")
S = 16


def _params(packed: bool, unbound: bool):
    prefer = packed and unbound
    maxcr = 127 if prefer else 255
    fullcopy = 5 if prefer else 4
    if not packed:
        min_short = S + 1 + 1 + 2          # 20
        min_medium = None
        min_long = S + 1 + 4 + fullcopy + 2
    else:
        min_short = 3
        min_medium = S + 1 + 1 + 1         # 19
        min_long = S + 1 + 4 + fullcopy + 1
    return prefer, maxcr, min_short, min_medium, min_long


def rle128_compress(data, *, byte_aligned: bool = False,
                    packed: bool = False) -> bytes:
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0 or n > (1 << 30):
        return b""
    unbound = byte_aligned
    prefer, maxcr, min_short, min_medium, min_long = _params(packed, unbound)

    pad = np.zeros(n + 64, np.uint8)
    pad[:n] = arr
    mv = pad.tobytes()
    # eq16[j] = pad[j] == pad[j+16] over the real bytes (j < n-16)
    m16 = max(n - S, 0)
    eq16 = np.zeros(n + 48, bool)
    if m16 > 0:
        eq16[:m16] = pad[:m16] == pad[S:S + m16]
    # E[j] = consecutive eq16 run from j
    E = np.zeros(n + 49, np.int64)
    if m16 > 0:
        rev = eq16[:m16][::-1]
        idx = np.arange(m16)
        last_false = np.maximum.accumulate(np.where(~rev, idx, -1))
        E[:m16] = (idx - last_false)[::-1]

    SIMDEND = n - S            # match-loop bound
    SCANEND = n - 2 * S        # skip-ahead bound

    out = bytearray(8)
    last_rle = 0
    last_symbol = b"\x00" * S
    i = 0
    count = 0
    # NB: the reference initializes symbol as xor(0, load(pIn)) — the
    # identity, not a complement (rle128_extreme_cpu.h:49) — so a stream
    # can open with a run at position 0.
    symbol = mv[0:S]

    def emit(symbol_b: bytes, count: int, rng: int, lit_lo: int, lit_hi: int,
             long_form: bool):
        nonlocal last_symbol
        if unbound:
            stored = count - min_short + 1
        else:
            stored = count // S - min_short // S + 1
        if not packed:
            out.extend(symbol_b)
            if stored <= 255:
                out.append(stored)
            else:
                out.append(0)
                out.extend(_U32.pack(stored))
        else:
            same = 0x80 if symbol_b == last_symbol else 0
            last_symbol = symbol_b
            if stored <= 0x7F:
                out.append(stored | same)
            else:
                out.append(same)
                out.extend(_U32.pack(stored))
            if not same:
                out.extend(symbol_b)
        if not long_form:
            out.append((rng << 1) & 0xFF if prefer else rng)
        else:
            if prefer:
                out.extend(_U32.pack(((rng << 1) | 1) & 0xFFFFFFFF))
            else:
                out.append(0)
                out.extend(_U32.pack(rng & 0xFFFFFFFF))
        out.extend(mv[lit_lo:lit_hi])

    def emission(i: int, count: int, symbol_b: bytes) -> None:
        nonlocal last_rle
        rng = i - last_rle - count + 1
        if not packed:
            ok = rng <= maxcr and count >= min_short
        else:
            ok = rng <= maxcr and (
                (count >= min_short and symbol_b == last_symbol)
                or count >= min_medium)
        if ok:
            emit(symbol_b, count, rng, last_rle, i - count, long_form=False)
            last_rle = i
        elif count >= min_long:
            emit(symbol_b, count, rng, last_rle, i - count, long_form=True)
            last_rle = i

    while i < n:
        # --- match loop (rle128_extreme_cpu.h:64-88) ---
        while i < SIMDEND:
            # prefix match of pad[i:i+16] vs symbol
            w = mv[i:i + S]
            if w == symbol:
                count += S
                i += S
                continue
            if unbound:
                t = 0
                for a, b in zip(w, symbol):
                    if a != b:
                        break
                    t += 1
                count += t
                i += t
            break
        # --- emission (B) ---
        emission(i, count, symbol)
        # --- skip-ahead (rle128_extreme_cpu.h:233-266) ---
        found = False
        while i < SCANEND:
            win = eq16[i:i + S]
            if win.all():
                symbol = mv[i:i + S]
                i += 2 * S
                count = 2 * S
                found = True
                break
            if not win[S - 1]:
                i += S
            else:
                h = int(np.flatnonzero(~win).max())
                i += h + 1
        if found:
            continue
        # --- scalar fallback (rle128_extreme_cpu.h:268-279) ---
        symbol = mv[i:i + S]
        if i + S <= n and mv[i + S:i + 2 * S] == symbol:
            count = 2 * S
            i += 2 * S
        else:
            count = 0
            i += 1

    # --- flush (rle128_extreme_cpu.h:282-496) ---
    rng = i - last_rle - count + 1
    if not packed:
        ok = rng <= maxcr and count >= min_short
    else:
        ok = rng <= maxcr and (
            (count >= min_short and symbol == last_symbol)
            or count >= min_medium)
    if ok or count >= min_long:
        if unbound:
            stored = count - min_short + 1
        else:
            stored = count // S - min_short // S + 1
        long_form = not ok
        emit(symbol, count, rng, last_rle, i - count, long_form=long_form)
        # terminator
        if not packed:
            out.extend(b"\x00" * S)
            out.append(0)
            out.extend(_U32.pack(0))
        else:
            out.append(0x80)
            out.extend(_U32.pack(0))
        if prefer:
            out.extend(_U32.pack(1))
        else:
            out.append(0)
            out.extend(_U32.pack(0))
    else:
        if not packed:
            out.extend(b"\x00" * S)
            out.append(0)
            out.extend(_U32.pack(0))
        else:
            out.append(0x80)
            out.extend(_U32.pack(0))
        copy_size = n - last_rle
        if prefer:
            out.extend(_U32.pack((((copy_size + 1) << 1) | 1) & 0xFFFFFFFF))
        else:
            out.append(0)
            out.extend(_U32.pack(copy_size + 1))
        out.extend(mv[last_rle:last_rle + copy_size])

    _U32.pack_into(out, 0, n)
    _U32.pack_into(out, 4, len(out))
    return bytes(out)


def rle128_decompress(buf, *, byte_aligned: bool = False,
                      packed: bool = False) -> bytes:
    buf = bytes(buf)
    unbound = byte_aligned
    prefer, _maxcr, min_short, _mm, _ml = _params(packed, unbound)
    usize, _csize = struct.unpack_from("<II", buf, 0)
    out = bytearray(usize + 160)
    p = 8
    pos = 0
    symbol = b"\x00" * S
    while True:
        if not packed:
            symbol = buf[p:p + S]; p += S
            stored = buf[p]; p += 1
            if stored == 0:
                stored = _U32.unpack_from(buf, p)[0]; p += 4
        else:
            b0 = buf[p]; p += 1
            same = b0 & 0x80
            stored = b0 & 0x7F
            if stored == 0:
                stored = _U32.unpack_from(buf, p)[0]; p += 4
            if not same:
                symbol = buf[p:p + S]; p += S
        if prefer:
            r0 = buf[p]
            if r0 & 1:
                rng = _U32.unpack_from(buf, p)[0] >> 1; p += 4
                if rng == 0:
                    break
            else:
                rng = r0 >> 1; p += 1
        else:
            rng = buf[p]; p += 1
            if rng == 0:
                rng = _U32.unpack_from(buf, p)[0]; p += 4
                if rng == 0:
                    break
        rng -= 1
        out[pos:pos + rng] = buf[p:p + rng]
        p += rng; pos += rng
        if stored == 0:
            break
        if not unbound:
            nbytes = (stored + min_short // S - 1) * S
        else:
            nbytes = stored + min_short - 1
        reps = -(-nbytes // S) + 1
        out[pos:pos + nbytes] = (symbol * reps)[:nbytes]
        pos += nbytes
    return bytes(out[:usize])
