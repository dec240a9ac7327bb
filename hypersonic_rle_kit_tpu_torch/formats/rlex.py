"""Generic multi-byte RLE family: 16/32/64-bit symbols, Symbol- or
Byte-aligned runs, optionally Packed.

Byte-exact reimplementation of `rleX_extreme_cpu.c` (instantiation matrix) +
`rleX_extreme_cpu_encode.h` / `rleX_extreme_cpu_decode.h`:

- container header: ``{u32 uncompressedLength, u32 compressedLength}``
  (rleX_extreme_cpu_encode.h:19-24).
- command: ``[symbol: s bytes (elided when Packed+sameSymbol)]
  [storedCount: u8, 0 -> u32 | packed: low7+sameBit, low7==0 -> u32]
  [range: u8, 0 -> u32 | byte_packed: 7-bit<<1 / u32|1][range-1 literals]``.
- emission cost model (rleX_extreme_cpu_encode.h:174-311): the short form
  requires ``range <= MAX_COPY_RANGE``; larger ranges require
  ``count >= MIN_RANGE_LONG``.
- Symbol-aligned counts are stored in units of symbols, Byte-aligned
  (UNBOUND) in bytes with partial-symbol tails matched via ``ctz(xor)``
  (rleX_extreme_cpu_encode.h:114-164).

The encoder emulates the reference's AVX2 code path faithfully, including its
`continue_outer_loop` scan structure and the guarded out-of-bounds tail read
at rleX_extreme_cpu_encode.h:371 (the reference compares against bytes past
the input; with the zero-initialized slack its benchmark buffers have, those
bytes read as 0, which this implementation reproduces).  For 16/32/64-bit
widths the emitted stream is ISA-independent (all tiers share one emission
condition), unlike the 8-bit packed family.
"""

from __future__ import annotations

import struct

import numpy as np

_U32 = struct.Struct("<I")


def _params(width: int, unbound: bool, packed: bool):
    s = width // 8
    prefer = packed and unbound          # PREFER_7_BIT_OR_4_BYTE_COPY
    maxcr = 127 if prefer else 255       # RLEX_EXTREME_MAX_COPY_RANGE
    fullcopy = 5 if prefer else 4        # RLEX_EXTRRME_FULL_COPY_SIZE
    if not packed:
        min_short = s + 1 + 1 + 2
        min_medium = None
        min_long = s + 1 + 4 + fullcopy + 2
    else:
        min_short = 1 + 1 + 1
        min_medium = s + 1 + 1 + 1
        min_long = s + 1 + 4 + fullcopy + 1
    return s, prefer, maxcr, min_short, min_medium, min_long


def _consec_eq(pad: np.ndarray, n: int, s: int) -> np.ndarray:
    """E[i] = number of consecutive positions j >= i with pad[j] == pad[j+s],
    only counting j < n - s (in-bounds period-s equality)."""
    m = max(n - s, 0)
    E = np.zeros(n + 1, np.int64)
    if m <= 0:
        return E
    eq = pad[:m] == pad[s:s + m]
    # reverse run-length of True
    rev = eq[::-1]
    idx = np.arange(m)
    last_false = np.maximum.accumulate(np.where(~rev, idx, -1))
    E[:m] = (idx - last_false)[::-1]
    return E


class _Emitter:
    def __init__(self, s: int, packed: bool, prefer: bool, min_short: int):
        self.out = bytearray(8)
        self.s = s
        self.packed = packed
        self.prefer = prefer
        self.min_short = min_short
        self.last_symbol = b"\x00" * s

    def emit(self, mv: bytes, symbol: bytes, count: int, rng: int,
             lit_lo: int, lit_hi: int, unbound: bool, long_form: bool):
        out, s = self.out, self.s
        if unbound:
            stored = count - self.min_short + 1
        else:
            stored = count // s - self.min_short // s + 1
        if not self.packed:
            out += symbol
            if stored <= 255:
                out.append(stored)
            else:
                out.append(0)
                out += _U32.pack(stored)
        else:
            same = 0x80 if symbol == self.last_symbol else 0
            self.last_symbol = symbol
            if stored <= 0x7F:
                out.append(stored | same)
            else:
                out.append(same)
                out += _U32.pack(stored)
            if not same:
                out += symbol
        if not long_form:
            if self.prefer:
                out.append((rng << 1) & 0xFF)
            else:
                out.append(rng)
        else:
            if self.prefer:
                out += _U32.pack(((rng << 1) | 1) & 0xFFFFFFFF)
            else:
                out.append(0)
                out += _U32.pack(rng & 0xFFFFFFFF)
        out += mv[lit_lo:lit_hi]

    def terminator(self):
        out, s = self.out, self.s
        if not self.packed:
            out += b"\x00" * s
            out.append(0)
            out += _U32.pack(0)
        else:
            out.append(0x80)
            out += _U32.pack(0)
        if self.prefer:
            out += _U32.pack(1)
        else:
            out.append(0)
            out += _U32.pack(0)

    def final_literals(self, mv: bytes, copy_size: int, lit_lo: int):
        # NB: copy_size derives from the final scan position i, which can
        # exceed the input length via the guarded OOB tail read; the extra
        # literal bytes come from the zeroed slack (rleX_extreme_cpu_encode.h:588)
        out = self.out
        if not self.packed:
            out += b"\x00" * self.s
            out.append(0)
            out += _U32.pack(0)
        else:
            out.append(0x80)
            out += _U32.pack(0)
        if self.prefer:
            out += _U32.pack((((copy_size + 1) << 1) | 1) & 0xFFFFFFFF)
        else:
            out.append(0)
            out += _U32.pack(copy_size + 1)
        out += mv[lit_lo:lit_lo + copy_size]


def rlex_compress(data, width: int, *, byte_aligned: bool = False,
                  packed: bool = False) -> bytes:
    """``rle{16,32,64}_{sym,byte}[_packed]_compress``
    (rleX_extreme_cpu_encode.h:14-609, AVX2 instantiation)."""
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0 or n > (1 << 30):
        return b""
    s, prefer, maxcr, min_short, min_medium, min_long = _params(
        width, byte_aligned, packed)
    unbound = byte_aligned
    W = 32                                   # AVX2 vector width
    SIMDEND = n - W - s

    pad = np.zeros(n + 2 * s + W + 8, np.uint8)
    pad[:n] = arr
    mv = pad.tobytes()
    E = _consec_eq(pad, n, s)
    # skip-ok: symbol_t at j equals symbol_t at j+s (E[j] >= s), j <= n-2s
    m = max(n - s, 0)
    ok = np.zeros(n + 1, bool)
    if m > 0:
        ok[:m] = E[:m] >= s
    ok_idx = np.where(ok, np.arange(n + 1), 1 << 60)
    nextskip = np.minimum.accumulate(ok_idx[::-1])[::-1]

    em = _Emitter(s, packed, prefer, min_short)
    last_rle = 0
    i = 0
    count = 0
    sym_pos = -1          # start position of the active run (-1: initial ~sym)

    def emission(i, count, symbol_bytes):
        nonlocal last_rle
        rng = i - last_rle - count + 1
        if not packed:
            short_ok = rng <= maxcr and count >= min_short
        else:
            short_ok = rng <= maxcr and (
                (count >= min_short and symbol_bytes == em.last_symbol)
                or count >= min_medium)
        if short_ok:
            em.emit(mv, symbol_bytes, count, rng, last_rle, i - count,
                    unbound, long_form=False)
            last_rle = i
        elif count >= min_long:
            em.emit(mv, symbol_bytes, count, rng, last_rle, i - count,
                    unbound, long_form=True)
            last_rle = i

    lim = W - s
    while i < n:
        # --- match phase (vector loop A + scalar continuation A') ---
        if count and sym_pos >= 0:
            re = sym_pos + s + int(E[sym_pos])      # first non-periodic byte
            # full-symbol extension (i - sym_pos is a multiple of s here)
            full = max(0, (re - i)) // s * s
            count += full
            i += full
            # partial byte tail: counted by the vector ctz when the break
            # lands before SIMDEND, by the guarded scalar ctz when
            # i+s <= n, and dropped at the very end of the buffer
            # (rleX_extreme_cpu_encode.h:69-99, 114-164)
            t = max(0, re - i)
            if t > 0 and unbound and (i < SIMDEND or i + s <= n):
                count += t
                i += t
            symbol_bytes = mv[sym_pos:sym_pos + s]
        else:
            symbol_bytes = (bytes((~b) & 0xFF for b in mv[0:s])
                            if sym_pos < 0 else mv[sym_pos:sym_pos + s])
        if i >= n:
            # the A' full-match `continue` re-tests the outer loop condition,
            # so a run reaching the end of the input exits without passing
            # the emission check — the flush emits it
            # (rleX_extreme_cpu_encode.h:108-113, 46)
            break
        # --- emission check (B) ---
        emission(i, count, symbol_bytes)
        # --- skip-ahead: C vector strides, then C' scalar fallback ---
        found = False
        if i < SIMDEND:
            j = int(nextskip[min(i, n)])
            if j - i > lim:
                steps_needed = -(-(j - i - lim) // lim)
                steps_bound = -(-(SIMDEND - i) // lim)
                i += lim * min(steps_needed, steps_bound)
            if i < SIMDEND:
                sym_pos = j
                count = 2 * s
                i = j + 2 * s
                found = True
        if not found:
            # C' scalar (rleX_extreme_cpu_encode.h:369-380): one step per
            # outer iteration, executed even when i has already reached
            # inSize (the load then reads the zeroed slack).  Between
            # failing steps, A (count==0) and B (count==0 fails every
            # emission condition) are no-ops, so stepping in place here is
            # faithful to the reference control flow.
            while True:
                sym_pos = i
                if i + s <= n and mv[i + s:i + 2 * s] == mv[i:i + s]:
                    count = 2 * s
                    i += 2 * s
                    found = True
                    break
                count = 0
                i += 1
                if i >= n:
                    break
        if not found and i >= n:
            break

    # --- flush ---
    symbol_bytes = (mv[sym_pos:sym_pos + s] if sym_pos >= 0
                    else bytes((~b) & 0xFF for b in mv[0:s]))
    rng = i - last_rle - count + 1
    if not packed:
        short_ok = rng <= maxcr and count >= min_short
    else:
        short_ok = rng <= maxcr and (
            (count >= min_short and symbol_bytes == em.last_symbol)
            or count >= min_medium)
    if short_ok:
        em.emit(mv, symbol_bytes, count, rng, last_rle, i - count,
                unbound, long_form=False)
        em.terminator()
    elif count >= min_long:
        em.emit(mv, symbol_bytes, count, rng, last_rle, i - count,
                unbound, long_form=True)
        em.terminator()
    else:
        em.final_literals(mv, i - last_rle, last_rle)

    out = em.out
    _U32.pack_into(out, 0, n)
    _U32.pack_into(out, 4, len(out))
    return bytes(out)


def rlex_decompress(buf, width: int, *, byte_aligned: bool = False,
                    packed: bool = False) -> bytes:
    """``rle{16,32,64}_*_decompress`` (rleX_extreme_cpu_decode.h:27-164)."""
    buf = bytes(buf)
    s, prefer, _maxcr, min_short, _mm, _ml = _params(width, byte_aligned, packed)
    usize, csize = struct.unpack_from("<II", buf, 0)
    out = bytearray(usize + 128 + 2 * s)
    p = 8
    pos = 0
    symbol = b"\x00" * s
    while True:
        if not packed:
            symbol = buf[p:p + s]; p += s
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
                symbol = buf[p:p + s]; p += s
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
        if not byte_aligned:
            nbytes = (stored + min_short // s - 1) * s
        else:
            nbytes = stored + min_short - 1
        reps = -(-nbytes // s) + 1
        out[pos:pos + nbytes] = (symbol * reps)[:nbytes]
        pos += nbytes
    return bytes(out[:usize])
