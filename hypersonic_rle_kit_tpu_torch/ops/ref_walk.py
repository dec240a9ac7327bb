"""Host grammar walkers of the reference-format streams (rle8 / rleX /
rle128 / LUT / Short families).

The port's own copy of the walkers of the JAX package's
``ops/ref_device.py`` (everything but its device decoder): each walks a
stream's command grammar once -- O(compressed), no expansion -- and lowers
it to the planar IR ``(sym, count, lit_len, lits)`` split into fixed-size
blocks, phase-major for multi-byte symbols (a run of an s-byte pattern is,
in each of the s phases, a plain byte run).  ``ops/ref_device.py`` uses
them where the native walk is missing.  The walkers mirror the byte-exact
host decoders in ``formats/``.
"""

from __future__ import annotations

import struct

import numpy as np

from ..formats import lut as lut_mod
from ..formats import rle128 as rle128_mod
from ..formats import rle8 as rle8_mod
from ..formats import rlex as rlex_mod
from ..formats import short as short_mod

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_ROW = 128
DEFAULT_BLOCK = 1 << 16


# ---------------------------------------------------------------------------
# grammar walkers: compressed stream -> (lit_off, lit_len, pattern, nbytes)
# ---------------------------------------------------------------------------
# Every walker yields commands in output order; ``pattern`` is the s-byte run
# symbol aligned to the run start, ``nbytes`` the run length in bytes
# (0 = final literal-only command).

def _iter_rle8(buf: bytes, packed: bool):
    """rle8_decompress grammar (rle8_extreme_cpu.h:702-764); multi and
    single modes, plain and packed builds."""
    usize, _csize, mode = rle8_mod._read_header(buf)
    p = rle8_mod.HEADER_SIZE
    if mode == rle8_mod.MODE_SINGLE:
        symbol = buf[p]; p += 1
        min_r = (rle8_mod.PACKED_SINGLE_MIN_RANGE_SHORT if packed
                 else rle8_mod.SINGLE_MIN_RANGE_SHORT)
        while True:
            stored = buf[p]; p += 1
            if stored == 0:
                stored = _U32.unpack_from(buf, p)[0]; p += 4
            rng = buf[p]; p += 1
            if rng == 0:
                rng = _U32.unpack_from(buf, p)[0]; p += 4
                if rng == 0:
                    return
            rng -= 1
            if stored == 0:
                yield p, rng, b"\x00", 0
                return
            yield p, rng, bytes([symbol]), stored + min_r - 1
            p += rng
        return
    if mode != rle8_mod.MODE_MULTI:
        return
    if not packed:
        while True:
            symbol = buf[p]; p += 1
            stored = buf[p]; p += 1
            if stored == 0:
                stored = _U32.unpack_from(buf, p)[0]; p += 4
            rng = buf[p]; p += 1
            if rng == 0:
                rng = _U32.unpack_from(buf, p)[0]; p += 4
                if rng == 0:
                    return
            rng -= 1
            if stored == 0:
                yield p, rng, b"\x00", 0
                return
            yield p, rng, bytes([symbol]), \
                stored + rle8_mod.MULTI_MIN_RANGE_SHORT - 1
            p += rng
    else:
        symbol = 0
        while True:
            b0 = buf[p]; p += 1
            same = b0 & 0x80
            stored = b0 & 0x7F
            if stored == 0:
                stored = _U32.unpack_from(buf, p)[0]; p += 4
            if not same:
                symbol = buf[p]; p += 1
            r0 = buf[p]
            if r0 & 1:
                rng = _U32.unpack_from(buf, p)[0] >> 1; p += 4
                if rng == 0:
                    return
            else:
                rng = r0 >> 1; p += 1
            rng -= 1
            if stored == 0:
                yield p, rng, b"\x00", 0
                return
            yield p, rng, bytes([symbol]), \
                stored + rle8_mod.PACKED_MIN_RANGE_SHORT - 1
            p += rng


def _iter_rlex(buf: bytes, width: int, byte_aligned: bool, packed: bool):
    """rleX_extreme_cpu_decode.h:27-164 grammar for 16/24/32/48/64-bit."""
    s, prefer, _maxcr, min_short, _mm, _ml = rlex_mod._params(
        width, byte_aligned, packed)
    p = 8
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
                    return
            else:
                rng = r0 >> 1; p += 1
        else:
            rng = buf[p]; p += 1
            if rng == 0:
                rng = _U32.unpack_from(buf, p)[0]; p += 4
                if rng == 0:
                    return
        rng -= 1
        if stored == 0:
            yield p, rng, symbol, 0
            return
        if not byte_aligned:
            nbytes = (stored + min_short // s - 1) * s
        else:
            nbytes = stored + min_short - 1
        yield p, rng, symbol, nbytes
        p += rng


def _iter_rle128(buf: bytes, byte_aligned: bool, packed: bool):
    """rle128_extreme_cpu.h grammar (16-byte symbols)."""
    S = rle128_mod.S
    prefer, _maxcr, min_short, _mm, _ml = rle128_mod._params(
        packed, byte_aligned)
    p = 8
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
                    return
            else:
                rng = r0 >> 1; p += 1
        else:
            rng = buf[p]; p += 1
            if rng == 0:
                rng = _U32.unpack_from(buf, p)[0]; p += 4
                if rng == 0:
                    return
        rng -= 1
        if stored == 0:
            yield p, rng, symbol, 0
            return
        if not byte_aligned:
            nbytes = (stored + min_short // S - 1) * S
        else:
            nbytes = stored + min_short - 1
        yield p, rng, symbol, nbytes
        p += rng


def _iter_lut(buf: bytes, width: int, lut: int, byte_aligned: bool):
    """rleX_Xsl.h:530-770 grammar (16-bit command headers + MTF LUT)."""
    s, range_bits, max_tc, max_tr, sym_shift, _ml = lut_mod._lut_params(
        width, lut)
    unbound = byte_aligned or width == 8
    p = 8
    lut_syms = lut_mod._init_lut(s, lut)
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
                return
        rng -= lut_mod.RANGE_OFFSET
        if stored == 0:
            yield p, rng, symbol, 0
            return
        if unbound:
            nbytes = stored + lut_mod.MIN_SHORT - lut_mod.COUNT_OFFSET
        else:
            nbytes = (stored + lut_mod.MIN_SHORT // s
                      - lut_mod.COUNT_OFFSET) * s
        yield p, rng, symbol, nbytes
        p += rng


def _iter_short(buf: bytes, width: int, lut: int, byte_aligned: bool,
                single: bool):
    """rleX_Xsl_short.h:1196-1464 grammar (1-byte commands + escapes)."""
    (s, min_short, _ml, _lut_bits, cbp, rbp, max_pr, _mpc, invalid, rb,
     _mtc, _mtr) = short_mod._short_params(width, lut, byte_aligned, single)
    unbound = byte_aligned or width == 8
    p = 8
    if single:
        symbol = buf[p:p + s]; p += s
        others: list[bytes] = []
    else:
        syms = short_mod._init_syms(s, lut)
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
                    return
        else:
            stored = count3 + short_mod.COUNT_OFFSET
            rng = (b0 & max_pr) + short_mod.RANGE_OFFSET
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
        rng -= short_mod.RANGE_OFFSET
        if stored == 0:
            yield p, rng, symbol, 0
            return
        if unbound:
            nbytes = stored + min_short - short_mod.COUNT_OFFSET
        else:
            nbytes = (stored + min_short // s - short_mod.COUNT_OFFSET) * s
        yield p, rng, symbol, nbytes
        p += rng


# ---------------------------------------------------------------------------
# planar writer: commands -> fixed-block planar columns
# ---------------------------------------------------------------------------

class _BlockWriter:
    """Accumulate (literal, run) spans for one byte stream of known total
    length, splitting at fixed ``block_size`` boundaries — the parallel
    replacement for the reference decoder's single output cursor."""

    def __init__(self, total: int, block_size: int):
        self.B = block_size
        self.nb = max(1, -(-total // block_size))
        self.total = total
        self.sym = [[] for _ in range(self.nb)]
        self.count = [[] for _ in range(self.nb)]
        self.lit_len = [[] for _ in range(self.nb)]
        self.lits = [bytearray() for _ in range(self.nb)]
        self.pos = 0
        self._pending = 0            # uncommitted literal bytes (cur block)

    def add_lits(self, data) -> None:
        i, n = 0, len(data)
        while i < n:
            k = self.pos // self.B
            room = (k + 1) * self.B - self.pos
            c = min(n - i, room)
            self.lits[k] += data[i:i + c]
            self._pending += c
            self.pos += c
            i += c
            if c == room:            # block filled mid-literal: commit tail
                self._commit(k, 0, 0)

    def add_run(self, sym_byte: int, length: int) -> None:
        while length > 0:
            k = self.pos // self.B
            room = (k + 1) * self.B - self.pos
            c = min(length, room)
            self._commit(k, sym_byte, c)
            self.pos += c
            length -= c

    def _commit(self, k: int, sym_byte: int, count: int) -> None:
        self.sym[k].append(sym_byte)
        self.count[k].append(count)
        self.lit_len[k].append(self._pending)
        self._pending = 0

    def finish(self):
        if self._pending or not self.sym[-1]:
            self._commit(self.nb - 1, 0, 0)
        block_len = np.full(self.nb, self.B, np.int32)
        block_len[-1] = self.total - (self.nb - 1) * self.B
        return block_len


def _stack_writers(writers, block_size: int):
    """Writers (one per phase) -> padded planar column arrays."""
    rows = []
    for b in writers:
        bl = b.finish()
        for k in range(b.nb):
            rows.append((b.sym[k], b.count[k], b.lit_len[k], b.lits[k],
                         int(bl[k])))
    nb = len(rows)
    cap = max(len(r[0]) for r in rows)
    cap = max(_ROW, -(-cap // _ROW) * _ROW)
    lcap = max(_ROW, -(-max(len(r[3]) for r in rows) // _ROW) * _ROW)
    sym = np.zeros((nb, cap), np.uint8)
    count = np.zeros((nb, cap), np.int32)
    lit_len = np.zeros((nb, cap), np.int32)
    lits = np.zeros((nb, lcap), np.uint8)
    n_cmds = np.zeros(nb, np.int32)
    n_lits = np.zeros(nb, np.int32)
    block_len = np.zeros(nb, np.int32)
    for i, (s, c, ll, lb, blen) in enumerate(rows):
        n_cmds[i] = len(s)
        n_lits[i] = len(lb)
        block_len[i] = blen
        sym[i, :len(s)] = s
        count[i, :len(c)] = c
        lit_len[i, :len(ll)] = ll
        lits[i, :len(lb)] = np.frombuffer(bytes(lb), np.uint8)
    return sym, count, lit_len, lits, n_cmds, n_lits, block_len


def parse_to_planar(buf: bytes, commands, usize: int, s: int,
                    block_size: int = DEFAULT_BLOCK):
    """Walk ``commands`` (a grammar iterator) once and lower to planar
    blocks.  For s > 1 the stream is phase-decomposed: phase r holds output
    positions ≡ r (mod s), each a plain byte stream of length ⌈usize/s⌉
    (zero-padded), giving ``s * nb_per_phase`` blocks total."""
    if s == 1:
        bld = _BlockWriter(usize, block_size)
        for p, rng, pattern, nbytes in commands:
            if rng:
                bld.add_lits(buf[p:p + rng])
            if nbytes:
                bld.add_run(pattern[0], nbytes)
        return [bld], _stack_writers([bld], block_size)

    m = -(-usize // s)
    writers = [_BlockWriter(m, block_size) for _ in range(s)]
    pos = 0
    for p, rng, pattern, nbytes in commands:
        if rng:
            for r in range(s):
                off = (r - pos) % s
                if off < rng:
                    writers[r].add_lits(buf[p + off:p + rng:s])
            pos += rng
        if nbytes:
            for r in range(s):
                off = (r - pos) % s
                if off < nbytes:
                    writers[r].add_run(pattern[off % len(pattern)],
                                        (nbytes - off + s - 1) // s)
            pos += nbytes
    for r in range(s):                      # pad ragged tail phases
        real = -(-max(usize - r, 0) // s)
        if m > real:
            writers[r].add_lits(b"\x00" * (m - real))
    return writers, _stack_writers(writers, block_size)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def _native_args(cspec):
    """(family, flags) for the csrc walker; None when no native walker."""
    from .. import spec as spec_mod
    F = spec_mod.Family
    flags = ((1 if cspec.packed else 0) | (2 if cspec.byte_aligned else 0)
             | (4 if cspec.single else 0))
    if cspec.family is F.RLE8:
        return 0, flags
    if cspec.family is F.RLEX:
        return (2 if cspec.width == 128 else 1), flags
    if cspec.family is F.LUT:
        return 3, flags
    if cspec.family is F.SHORT and not cspec.greedy:
        return 4, flags
    if cspec.family is F.SHORT:          # greedy shares the Short decoder
        return 4, flags
    return None, 0


def _iter_for(cspec, buf: bytes):
    """Grammar iterator + (usize, symbol width) for a codec spec."""
    from .. import spec as spec_mod
    F = spec_mod.Family
    if cspec.family is F.RLE8:
        usize = rle8_mod._read_header(buf)[0]
        return _iter_rle8(buf, bool(cspec.packed)), usize, 1
    usize = struct.unpack_from("<II", buf, 0)[0]
    s = cspec.width // 8
    byte_aligned = bool(cspec.byte_aligned)
    if cspec.family is F.RLEX:
        if cspec.width == 128:
            return (_iter_rle128(buf, byte_aligned, bool(cspec.packed)),
                    usize, 16)
        return (_iter_rlex(buf, cspec.width, byte_aligned,
                           bool(cspec.packed)), usize, s)
    if cspec.family is F.LUT:
        return (_iter_lut(buf, cspec.width, cspec.lut, byte_aligned),
                usize, s)
    if cspec.family is F.SHORT:
        return (_iter_short(buf, cspec.width, cspec.lut, byte_aligned,
                            bool(cspec.single)), usize, s)
    raise ValueError(f"no reference-stream device path for {cspec.name!r}")
