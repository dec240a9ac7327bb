"""Short-command RLE family: 0/1/3/7-LUT "Short" codecs (+ Single, + Greedy).

Byte-exact reimplementation of `rleX_Xsl_short.{c,h}` +
`rleX_Xsl_short_multibyte_encoder.h`.  A whole command can fit one byte:

    [lut(0-3 bits) | count3(2-4 bits) | range3(3-4 bits)]

with escape: packed-count == all-ones selects a 3-byte 19-bit header
``lut | INVALID | storedCount(9 bits) | range(9-11 bits)`` whose count/range
fields escape further to u16 (==1) / u32 (==0) (rleX_Xsl_short.h:13-42,
266-347); count and range are stored with value offset 2; the terminator is
an extended header with range-extension 0 (rleX_Xsl_short.h:458-517).

Variants (rleX_Xsl_short.c instantiation matrix):
- widths 8..64, LUT sizes 0/1/3/7, Symbol/Byte aligned (widths > 8);
- `8 Bit Single Short`: the single best RLE symbol chosen up front by the
  shared approximate histogram scan, then only runs of that symbol encoded;
- Greedy (Byte-aligned, LUT>0): encoder-only strategy that additionally
  matches partial prefixes of LUT symbols to start runs early
  (rleX_Xsl_short.h:746-1054); decoders are shared with the plain Short.
"""

from __future__ import annotations

import struct

import numpy as np

from .rlex import _consec_eq
from .rle8 import _approx_optimal_symbol

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

COUNT_OFFSET = 2
RANGE_OFFSET = 2


def _short_params(width: int, sc: int, unbound: bool, single: bool):
    s = width // 8
    if sc != 0 or single:
        min_short = 2
        min_long = (3 + 4 + 4) if single else (3 + 4 + 4 + s)
    else:
        min_short = 1 + s + 1
        min_long = 3 + 4 + 4 + s + 1
    lut_bits = {0: 0, 1: 1, 3: 2, 7: 3}[sc]
    cbp = {0: 4, 1: 3, 3: 3, 7: 2}[sc]
    rbp = 8 - lut_bits - cbp
    max_pr = (1 << rbp) - 1
    max_pc = (1 << cbp) - 2
    invalid = (1 << cbp) - 1
    if sc != 7:
        rb = 24 - lut_bits - cbp - 9
    else:
        rb = 24 - lut_bits - rbp - 9
    max_tc = (1 << 9) - 1
    max_tr = (1 << rb) - 1
    return (s, min_short, min_long, lut_bits, cbp, rbp, max_pr, max_pc,
            invalid, rb, max_tc, max_tr)


def _init_syms(s: int, sc: int) -> list[bytes]:
    if sc == 1:
        return [b"\x00" * s]
    base = [0x00, 0x7F, 0xFF, 0x01, 0x7E, 0x80, 0xFE]
    return [bytes([b]) * s for b in base[:sc]]


class _ShortEmitter:
    """process_symbol (rleX_Xsl_short.h:156-372)."""

    def __init__(self, width: int, sc: int, byte_aligned: bool, single: bool):
        (self.s, self.min_short, self.min_long, self.lut_bits, self.cbp,
         self.rbp, self.max_pr, self.max_pc, self.invalid, self.rb,
         self.max_tc, self.max_tr) = _short_params(width, sc, byte_aligned,
                                                   single)
        self.sc = sc
        self.single = single
        self.unbound = byte_aligned or width == 8
        self.last_symbols = _init_syms(self.s, sc)
        self.out = bytearray(8)
        self.last_rle = 0

    def process_symbol(self, mv: bytes, i: int, count: int,
                       symbol: bytes) -> bool:
        s, sc = self.s, self.sc
        if sc > 1:
            match = 0
            while match < sc and self.last_symbols[match] != symbol:
                match += 1
        elif sc == 1:
            match = int(symbol != self.last_symbols[0])
        else:
            match = 0

        rng = i - self.last_rle - count + RANGE_OFFSET
        if self.unbound:
            stored = count - self.min_short + COUNT_OFFSET
        else:
            stored = count // s - self.min_short // s + COUNT_OFFSET

        count3 = stored - COUNT_OFFSET
        range3 = rng - RANGE_OFFSET
        # uint64 wrap in the reference: negative values never pack
        pack = (0 <= range3 <= self.max_pr) and (0 <= count3 <= self.max_pc)
        is19 = stored <= self.max_tc and rng <= self.max_tr

        penalty = (s if (sc != 0 and match == sc) else 0)
        if not pack:
            penalty += 2
            if not is19:
                penalty += ((0 if rng <= self.max_tr else 2)
                            if rng <= 0xFFFFF else 4)
                penalty += ((0 if stored <= self.max_tc else 2)
                            if stored <= 0xFFFFF else 4)

        if not (count >= self.min_long or count >= self.min_short + penalty):
            return False

        # MTF update (rleX_Xsl_short.h:202-263)
        if sc == 1:
            if match:
                self.last_symbols[0] = symbol
        elif sc > 1 and match > 0:
            upto = min(match, sc - 1)
            for k in range(upto, 0, -1):
                self.last_symbols[k] = self.last_symbols[k - 1]
            self.last_symbols[0] = symbol

        out = self.out
        if pack:
            b0 = (count3 << self.rbp) | range3
            if sc != 0:
                b0 |= match << (self.cbp + self.rbp)
            out.append(b0)
        else:
            storedx = (stored if 0 <= stored <= self.max_tc
                       else (1 if stored <= 0xFFFF else 0))
            rangex = (rng if rng <= self.max_tr
                      else (1 if rng <= 0xFFFF else 0))
            vp1 = (self.invalid << self.rbp) | ((storedx << (self.rb - 8)) >> 8)
            if sc != 0:
                vp1 |= match << (self.cbp + self.rbp)
            vp2 = ((storedx << (self.rb - 8)) | (rangex >> 8)) & 0xFF
            out.append(vp1 & 0xFF)
            out.append(vp2)
            out.append(rangex & 0xFF)
            if stored != storedx:
                if stored <= 0xFFFF:
                    out += _U16.pack(stored)
                else:
                    out += _U32.pack(stored & 0xFFFFFFFF)
            if rng != rangex:
                if rng <= 0xFFFF:
                    out += _U16.pack(rng)
                else:
                    out += _U32.pack(rng & 0xFFFFFFFF)

        if not self.single and (sc == 0 or match == sc):
            out += symbol

        out += mv[self.last_rle:i - count]
        self.last_rle = i
        return True

    def flush(self, mv: bytes, i: int, count: int, symbol: bytes) -> None:
        out = self.out
        b1 = {3: 0b100, 1: 0b1000, 0: 0b1000, 7: 0b10}[self.sc]
        if self.process_symbol(mv, i, count, symbol):
            out.append(self.invalid << self.rbp)
            out.append(b1)
            out.append(1)
            out += _U16.pack(0)
            out += _U16.pack(0)
            if self.sc == 0 and not self.single:
                out.append(0)
        else:
            copy_size = i - self.last_rle
            out.append(self.invalid << self.rbp)
            out.append(b1)
            out.append(0)
            out += _U16.pack(0)
            out += _U32.pack(copy_size + RANGE_OFFSET)
            if self.sc == 0 and not self.single:
                out += b"\x00" * self.s
            out += mv[self.last_rle:self.last_rle + copy_size]

    def finalize(self, n: int) -> bytes:
        _U32.pack_into(self.out, 0, n)
        _U32.pack_into(self.out, 4, len(self.out))
        return bytes(self.out)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def _compress_short8(arr: np.ndarray, sc: int) -> bytes:
    """8-bit multi Short: every maximal run is a candidate
    (rleX_Xsl_short.h:381-523, 528-663)."""
    n = int(arr.size)
    em = _ShortEmitter(8, sc, byte_aligned=False, single=False)
    mv = arr.tobytes()

    change = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    starts = np.concatenate(([0], change))
    lengths = np.concatenate((change, [n])) - starts
    cand = np.flatnonzero(lengths >= em.min_short)

    syms = arr[starts]
    for k in cand.tolist():
        s0 = int(starts[k])
        count = int(lengths[k])
        i = s0 + count
        if i == n:
            break
        em.process_symbol(mv, i, count, bytes([int(syms[k])]))

    count = int(lengths[-1]) if n else 0
    sym = bytes([int(arr[-1])]) if n else b"\x00"
    em.flush(mv, n, count, sym)
    return em.finalize(n)


def _compress_short8_single(arr: np.ndarray) -> bytes:
    """8 Bit Single Short (rleX_Xsl_short.h:1060-1122 + shared tail/flush)."""
    n = int(arr.size)
    em = _ShortEmitter(8, 0, byte_aligned=False, single=True)
    sym_v = _approx_optimal_symbol(arr)
    sym = bytes([sym_v])
    em.out.append(sym_v)
    mv = arr.tobytes()

    ms = arr == sym_v
    # rs[i]: consecutive matches from i
    rev = ms[::-1]
    idx = np.arange(n)
    last_false = np.maximum.accumulate(np.where(~rev, idx, -1))
    rs = (idx - last_false)[::-1]
    P = np.concatenate(([0], np.cumsum(ms.astype(np.int64))))   # prefix sums
    nt_idx = np.where(ms, np.arange(n), 1 << 60)
    next_true = np.minimum.accumulate(nt_idx[::-1])[::-1]

    E = n - 16
    i = 0
    count = 0
    while i < E:
        m = int(rs[i])
        if m >= 16:
            f = min(m // 16, (E - 1 - i) // 16 + 1)
            count += 16 * f
            i += 16 * f
            continue
        window_any = (P[min(i + 16, n)] - P[i]) > 0
        if window_any or count > 1:           # mask != 0 || count > 1
            count += m
            i += m
            em.process_symbol(mv, i, count, sym)
        count = 0
        # skip-ahead (rleX_Xsl_short.h:1096-1117)
        while i < E:
            c = int(P[i + 16] - P[i])
            if c == 0 or ((not ms[i + 15]) and c < em.min_short):
                i += 16
            else:
                z = int(next_true[i]) - i
                i += z
                count = 1
                break
        i += 1   # for-loop increment

    while i < n:
        if arr[i] == sym_v:
            count += 1
        else:
            em.process_symbol(mv, i, count, sym)
            count = 0
        i += 1

    em.flush(mv, n, count, sym)
    return em.finalize(n)


def _compress_shortx(arr: np.ndarray, width: int, sc: int,
                     byte_aligned: bool) -> bytes:
    """Multibyte Short: the shared AVX2 scan skeleton
    (rleX_Xsl_short_multibyte_encoder.h)."""
    n = int(arr.size)
    s = width // 8
    unbound = byte_aligned
    W = 32
    SIMDEND = n - W - s

    pad = np.zeros(n + 2 * s + W + 8, np.uint8)
    pad[:n] = arr
    mv = pad.tobytes()
    E = _consec_eq(pad, n, s)
    m = max(n - s, 0)
    ok = np.zeros(n + 1, bool)
    if m > 0:
        ok[:m] = E[:m] >= s
    ok_idx = np.where(ok, np.arange(n + 1), 1 << 60)
    nextskip = np.minimum.accumulate(ok_idx[::-1])[::-1]

    em = _ShortEmitter(width, sc, byte_aligned, single=False)
    i = 0
    count = 0
    sym_pos = -1
    lim = W - s

    def symbol_at(sp: int) -> bytes:
        if sp < 0:
            return bytes((~b) & 0xFF for b in mv[0:s])
        return mv[sp:sp + s]

    while i < n:
        if count and sym_pos >= 0:
            re = sym_pos + s + int(E[sym_pos])
            full = max(0, (re - i)) // s * s
            count += full
            i += full
            t = max(0, re - i)
            if t > 0 and unbound and (i < SIMDEND or i + s <= n):
                count += t
                i += t
        symbol_bytes = symbol_at(sym_pos)
        if i >= n:
            break
        em.process_symbol(mv, i, count, symbol_bytes)
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

    em.flush(mv, i, count, symbol_at(sym_pos))
    return em.finalize(n)


def _match_len(a: bytes, b: bytes, s: int) -> int:
    """rleX_Xsl_short_get_match_length: leading equal bytes (16-bit: full or
    first byte only)."""
    if a == b:
        return s
    if s == 2:
        return 1 if a[0] == b[0] else 0
    t = 0
    for x, y in zip(a, b):
        if x != y:
            break
        t += 1
    return t


def _compress_shortx_greedy(arr: np.ndarray, width: int, sc: int) -> bytes:
    """Greedy Short (Byte): scalar loop with partial LUT-prefix matching
    (rleX_Xsl_short.h:746-1054)."""
    from ..utils import native
    fast = native.short_greedy_encode(arr, width, sc)  # byte-exact C++ tier
    if fast is not None:
        return fast
    n = int(arr.size)
    s = width // 8
    pad = np.zeros(n + 2 * s + 8, np.uint8)
    pad[:n] = arr
    mv = pad.tobytes()

    em = _ShortEmitter(width, sc, byte_aligned=True, single=False)
    symbol = bytes((~b) & 0xFF for b in mv[0:s])
    count = 0
    i = 0
    min_short = em.min_short

    while i < n:
        if count:
            if i + s <= n:
                nxt = mv[i:i + s]
                if nxt == symbol:
                    count += s
                    i += s
                    continue
                else:
                    # partial tail (UNBOUND)
                    if s == 2:
                        if mv[i] == symbol[0]:
                            count += 1
                            i += 1
                    else:
                        t = 0
                        for a, b in zip(nxt, symbol):
                            if a != b:
                                break
                            t += 1
                        count += t
                        i += t
        # `not_a_full_match_but_a_match` block
        while True:
            if count >= 2:   # below min_short the call can never emit
                em.process_symbol(mv, i, count, symbol)
            symbol = mv[i:i + s]
            fits = i + s <= n
            if fits and mv[i + s:i + 2 * s] == symbol:
                count = 2 * s
                i += 2 * s
                break
            if fits:
                nxt = symbol      # == mv[i:i+s]
                possible_count = 0
                possible_idx = 0
                if sc == 1:
                    if s == 2:
                        possible_count = 2 if em.last_symbols[0] == nxt else 0
                    else:
                        possible_count = _match_len(em.last_symbols[0], nxt, s)
                else:
                    for j in range(sc):
                        if s == 2:
                            if em.last_symbols[j] == nxt:
                                possible_count = 2
                                possible_idx = j
                                break
                        else:
                            if nxt == em.last_symbols[j]:
                                possible_idx = j
                                possible_count = s
                                break
                            psc = _match_len(nxt, em.last_symbols[j], s)
                            if psc > possible_count:
                                possible_idx = j
                                possible_count = psc
                if (possible_count >= min_short if s != 2 else possible_count):
                    count = possible_count
                    i += possible_count
                    symbol = em.last_symbols[0] if sc == 1 else \
                        em.last_symbols[possible_idx]
                    if s != 2 and count < s:
                        continue          # goto not_a_full_match_but_a_match
                    break
                else:
                    count = 0
                    i += 1
                    break
            else:
                count = 0
                i += 1
                break

    em.flush(mv, i, count, symbol)
    return em.finalize(n)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def short_compress(data, width: int, lut: int, *, byte_aligned: bool = False,
                   single: bool = False, greedy: bool = False) -> bytes:
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0 or n > (1 << 30):
        return b""
    if single:
        return _compress_short8_single(arr)
    if width == 8:
        return _compress_short8(arr, lut)
    if greedy:
        return _compress_shortx_greedy(arr, width, lut)
    return _compress_shortx(arr, width, lut, byte_aligned)


def short_decompress(buf, width: int, lut: int, *, byte_aligned: bool = False,
                     single: bool = False) -> bytes:
    """rleX_Xsl_short.h:1196-1464 (scalar semantics)."""
    buf = bytes(buf)
    (s, min_short, _ml, lut_bits, cbp, rbp, max_pr, _mpc, invalid, rb,
     _mtc, _mtr) = _short_params(width, lut, byte_aligned, single)
    unbound = byte_aligned or width == 8
    usize, _csize = struct.unpack_from("<II", buf, 0)
    out = bytearray(usize + 160 + 2 * s)
    p = 8
    pos = 0
    if single:
        symbol = buf[p:p + s]
        p += s
        others: list[bytes] = []
    else:
        syms = _init_syms(s, lut)
        symbol = syms[0] if lut else b"\x00" * s
        others = syms[1:] if lut > 1 else []

    while True:
        b0 = buf[p]; p += 1
        sym_idx = b0 >> (cbp + rbp)
        count3 = (b0 >> rbp) & invalid

        if count3 == invalid:
            b1 = buf[p]; p += 1
            b2 = buf[p]; p += 1
            stored = (b1 >> (rb - 8)) | ((b0 & max_pr) << (8 - (rb - 8)))
            rng = b2 | ((b1 & ((1 << (rb - 8)) - 1)) << 8)
            if stored == 0:
                stored = _U32.unpack_from(buf, p)[0]; p += 4
            elif stored == 1:
                stored = _U16.unpack_from(buf, p)[0]; p += 2
            if rng == 0:
                rng = _U32.unpack_from(buf, p)[0]; p += 4
            elif rng == 1:
                rng = _U16.unpack_from(buf, p)[0]; p += 2
                if rng == 0:
                    break
        else:
            stored = count3 + COUNT_OFFSET
            rng = (b0 & max_pr) + RANGE_OFFSET

        if not single:
            if lut == 0:
                symbol = buf[p:p + s]; p += s
            elif lut == 1:
                if sym_idx == 1:
                    symbol = buf[p:p + s]; p += s
            else:
                if sym_idx == lut:
                    others[1:] = others[:-1]
                    others[0] = symbol
                    symbol = buf[p:p + s]; p += s
                elif sym_idx > 0:
                    tmp = others[sym_idx - 1]
                    others[1:sym_idx] = others[:sym_idx - 1]
                    others[0] = symbol
                    symbol = tmp

        rng -= RANGE_OFFSET
        out[pos:pos + rng] = buf[p:p + rng]
        p += rng; pos += rng
        if stored == 0:
            break
        if unbound:
            nbytes = stored + min_short - COUNT_OFFSET
        else:
            nbytes = (stored + min_short // s - COUNT_OFFSET) * s
        reps = -(-nbytes // s) + 1
        out[pos:pos + nbytes] = (symbol * reps)[:nbytes]
        pos += nbytes

    return bytes(out[:usize])
