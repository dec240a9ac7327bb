"""N-symbol-LUT RLE family (non-Short): 3LUT / 7LUT, widths 8..64.

Byte-exact reimplementation of `rleX_Xsl.{c,h}` + `rleX_Xsl_multibyte_encoder.h`:

- header: ``{u32 uncompressedLength, u32 compressedLength}``.
- command: 16-bit header ``symbolIndex(2|3 bits) | storedCount7(7 bits) |
  range7(7|6 bits)`` with escape codes 1 -> u16 extra, 0 -> u32 extra
  (rleX_Xsl.h:190-250), optional inline symbol when the run symbol is not in
  the LUT, then literals.
- LUT = move-to-front list of the last 3/7 distinct emitted run symbols,
  initialized {0x00,0x7F,0xFF} (+{0x01,0x7E,0x80,0xFE}) byte-broadcast
  (rleX_Xsl.h:279-287, rleX_Xsl_multibyte_encoder.h:31-39); updated only when
  a command is emitted, identically by encoder and decoder.
- emission cost model: ``count >= MIN_LONG or count >= MIN_SHORT + penalty``
  where penalty charges 2/4 bytes for escaped counts/ranges and 1 for a
  LUT miss (rleX_Xsl.h:130-132; note the reference compares against 0xFFFFF
  -- five F's -- which this implementation reproduces).
- count stored with value offset 2 in symbols (Symbol codecs) or bytes
  (Byte codecs / 8-bit); range with value offset 2 in bytes.
- terminator: count7==1,u16(0) then range7==1,u16(0) (rleX_Xsl.h:319-324);
  trailing literals use count7==1,u16(0),range7==0,u32(copySize+2).

The multibyte encoder shares the scan skeleton of rleX_extreme_cpu_encode.h
(same AVX2 vector loop, guarded slack reads, emission-skip when the input
ends mid-match); the 8-bit encoder walks every maximal run (rleX_Xsl.h:352-485).
"""

from __future__ import annotations

import struct

import numpy as np

from .rlex import _consec_eq

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

MIN_SHORT = 3                 # RLE8_XSYMLUT_MIN_RANGE_SHORT (2+1)
COUNT_OFFSET = 2
RANGE_OFFSET = 2
COUNT_BITS = 7


def _lut_params(width: int, lut: int):
    s = width // 8
    range_bits = 7 if lut == 3 else 6
    max_tiny_count = (1 << COUNT_BITS) - 1
    max_tiny_range = (1 << range_bits) - 1
    sym_shift = 14 if lut == 3 else 13
    min_long = 2 + 4 + 4 + s
    return s, range_bits, max_tiny_count, max_tiny_range, sym_shift, min_long


def _init_lut(s: int, lut: int) -> list[bytes]:
    base = [0x00, 0x7F, 0xFF, 0x01, 0x7E, 0x80, 0xFE]
    return [bytes([b]) * s for b in base[:lut]]


class _LutEmitter:
    """process_symbol (rleX_Xsl.h:114-264): cost model + MTF + serialization."""

    def __init__(self, width: int, lut: int, byte_aligned: bool):
        (self.s, self.range_bits, self.max_tiny_count, self.max_tiny_range,
         self.sym_shift, self.min_long) = _lut_params(width, lut)
        self.lut = lut
        self.unbound = byte_aligned or width == 8
        self.last_symbols = _init_lut(self.s, lut)
        self.out = bytearray(8)
        self.last_rle = 0

    def process_symbol(self, mv: bytes, i: int, count: int,
                       symbol: bytes) -> bool:
        s = self.s
        match = 0
        while match < self.lut and self.last_symbols[match] != symbol:
            match += 1

        rng = i - self.last_rle - count + RANGE_OFFSET
        if self.unbound:
            stored = count - MIN_SHORT + COUNT_OFFSET
        else:
            stored = count // s - MIN_SHORT // s + COUNT_OFFSET

        penalty = ((0 if rng <= self.max_tiny_range else 2)
                   if rng <= 0xFFFFF else 4)
        penalty += ((0 if stored <= self.max_tiny_count else 2)
                    if stored <= 0xFFFFF else 4)
        penalty += int(match == self.lut)

        if not (count >= self.min_long or count >= MIN_SHORT + penalty):
            return False

        # MTF update (encoder side, rleX_Xsl.h:134-188): shift positions
        # match..1 down; a miss (match == lut) drops the last entry
        if match > 0:
            upto = min(match, self.lut - 1)
            for k in range(upto, 0, -1):
                self.last_symbols[k] = self.last_symbols[k - 1]
            self.last_symbols[0] = symbol

        stored7 = (stored if stored <= self.max_tiny_count
                   else (1 if stored <= 0xFFFF else 0))
        range7 = (rng if rng <= self.max_tiny_range
                  else (1 if rng <= 0xFFFF else 0))

        out = self.out
        value = (match << self.sym_shift) | (stored7 << self.range_bits) | range7
        out += _U16.pack(value & 0xFFFF)
        if match == self.lut:
            out += symbol
        if stored != stored7:
            if stored <= 0xFFFF:
                out += _U16.pack(stored)
            else:
                out += _U32.pack(stored & 0xFFFFFFFF)
        if rng != range7:
            if rng <= 0xFFFF:
                out += _U16.pack(rng)
            else:
                out += _U32.pack(rng & 0xFFFFFFFF)
        out += mv[self.last_rle:i - count]
        self.last_rle = i
        return True

    def flush(self, mv: bytes, i: int, count: int, symbol: bytes,
              n: int) -> None:
        out = self.out
        if self.process_symbol(mv, i, count, symbol):
            out += _U16.pack((1 << self.range_bits) | 1)
            out += _U16.pack(0)
            out += _U16.pack(0)
        else:
            # copy size uses the final scan position i, which can exceed n
            # via the guarded OOB tail read (zeroed slack)
            copy_size = i - self.last_rle
            out += _U16.pack(1 << self.range_bits)
            out += _U16.pack(0)
            out += _U32.pack(copy_size + RANGE_OFFSET)
            out += mv[self.last_rle:self.last_rle + copy_size]

    def finalize(self, n: int) -> bytes:
        _U32.pack_into(self.out, 0, n)
        _U32.pack_into(self.out, 4, len(self.out))
        return bytes(self.out)


def _compress_lut8(arr: np.ndarray, lut: int) -> bytes:
    """8-bit LUT encoder: every maximal run is a candidate; the LUT state
    advances only on emission (rleX_Xsl.h:268-346, 352-485)."""
    n = int(arr.size)
    em = _LutEmitter(8, lut, byte_aligned=False)
    mv = arr.tobytes()

    change = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    starts = np.concatenate(([0], change))
    lengths = np.concatenate((change, [n])) - starts
    # candidate runs: emission needs count >= MIN_SHORT (penalty >= 0)
    cand = np.flatnonzero(lengths >= MIN_SHORT)

    syms = arr[starts]
    for k in cand.tolist():
        s0 = int(starts[k])
        count = int(lengths[k])
        i = s0 + count
        if i == n:
            break                     # flush handles the trailing run
        em.process_symbol(mv, i, count, bytes([int(syms[k])]))

    count = int(lengths[-1]) if n else 0
    sym = bytes([int(arr[-1])]) if n else b"\x00"
    # flush uses the state's trailing-run count only if it belongs to the
    # final maximal run; otherwise count was reset by intermediate symbols
    em.flush(mv, n, count, sym, n)
    return em.finalize(n)


def _compress_lutx(arr: np.ndarray, width: int, lut: int,
                   byte_aligned: bool) -> bytes:
    """Multibyte LUT encoder: the rleX_extreme AVX2 scan skeleton with
    process_symbol as the emission step (rleX_Xsl_multibyte_encoder.h)."""
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

    em = _LutEmitter(width, lut, byte_aligned)
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

    em.flush(mv, i, count, symbol_at(sym_pos), n)
    return em.finalize(n)


def lut_compress(data, width: int, lut: int, *,
                 byte_aligned: bool = False) -> bytes:
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0 or n > (1 << 30):
        return b""
    if width == 8:
        return _compress_lut8(arr, lut)
    return _compress_lutx(arr, width, lut, byte_aligned)


def lut_decompress(buf, width: int, lut: int, *,
                   byte_aligned: bool = False) -> bytes:
    """rleX_Xsl.h:530-770 (scalar semantics of the SIMD decoders)."""
    buf = bytes(buf)
    s, range_bits, max_tc, max_tr, sym_shift, _ml = _lut_params(width, lut)
    unbound = byte_aligned or width == 8
    usize, _csize = struct.unpack_from("<II", buf, 0)
    out = bytearray(usize + 160 + 2 * s)
    p = 8
    pos = 0
    lut_syms = _init_lut(s, lut)
    symbol = lut_syms[0]
    others = lut_syms[1:]

    while True:
        value = _U16.unpack_from(buf, p)[0]; p += 2
        rng = value & max_tr
        stored = (value >> range_bits) & max_tc
        sym_idx = value >> sym_shift

        if sym_idx == lut:
            others[1:] = others[:-1]
            others[0] = symbol
            symbol = buf[p:p + s]; p += s
        elif sym_idx > 0:
            tmp = others[sym_idx - 1]
            others[1:sym_idx] = others[:sym_idx - 1]
            others[0] = symbol
            symbol = tmp

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
        rng -= RANGE_OFFSET

        out[pos:pos + rng] = buf[p:p + rng]
        p += rng; pos += rng
        if stored == 0:
            break
        if unbound:
            nbytes = stored + MIN_SHORT - COUNT_OFFSET
        else:
            nbytes = (stored + MIN_SHORT // s - COUNT_OFFSET) * s
        reps = -(-nbytes // s) + 1
        out[pos:pos + nbytes] = (symbol * reps)[:nbytes]
        pos += nbytes

    return bytes(out[:usize])
