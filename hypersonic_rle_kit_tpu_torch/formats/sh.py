"""RLE8 SH — "RLE + Huffman-esque" (rle_sh.c).

Two streams in one buffer: a forward byte stream (symbols, block lengths,
literal blocks) and a bit stream of prefix codes that the encoder grows
*backward* from the end of its scratch buffer and finally moves to sit after
the forward stream, in reverse byte order (rle_sh.c:20-58, 487-504).

Prefix codes, written LSB-first (rle_sh.c:62-81):

    0                         last RLE symbol (1 byte of it)
    1 0                       literal symbol (byte in forward stream)
    1 1 0                     2nd recent symbol
    1 1 1 0                   3rd recent symbol (1 1 1 inside encoded-copy)
    1 1 1 1 0                 small RLE block: u8 len (+14) of last RLE symbol
    1 1 1 1 1 b5 b6           blocks: (0,0) copy small u8(+7) raw
                                      (1,0) copy large u32(+7) raw; u32==0 ends
                                      (0,1) RLE large u32(+14) + symbol byte
                                            (becomes the last RLE symbol)
                                      (1,1) encoded copy u8(+161): that many
                                            symbols via the sub-codes above

The adaptive model keeps (lastRleSymbol, secondMostImportant,
thirdMostImportant, lastOccuredSymbol), initialized 0x7F/0x80/0x7E/0x80; a
literal equal to the previous literal promotes into second/third
(rle_sh.c:98-267).  The encoder's block segmentation heuristics
(rle_sh.c:300-485) are transliterated verbatim.
"""

from __future__ import annotations

import struct

import numpy as np

_U32 = struct.Struct("<I")

MIN_COPY = 7
MIN_RLE = 14
MIN_CHANGE = 10
MIN_ENC_COPY = 161


class _BitWriter:
    """rle8_sh_write_bits: LSB-first into bytes completed in backward order."""

    def __init__(self):
        self.completed: list[int] = []
        self.cur = 0
        self.nextbit = 0

    def write(self, bits: int, count: int):
        v = bits
        for _ in range(count):
            self.cur |= (v & 1) << self.nextbit
            v >>= 1
            self.nextbit = (self.nextbit + 1) & 7
            if self.nextbit == 0:
                self.completed.append(self.cur)
                self.cur = 0

    def finish(self) -> bytes:
        out = []
        if self.nextbit != 0:
            out.append(self.cur)
        out.extend(reversed(self.completed))
        return bytes(out)


class _Model:
    __slots__ = ("last_rle", "second", "third", "last_occured")

    def __init__(self):
        self.last_rle = 0x7F
        self.second = 0x80
        self.third = 0x7E
        self.last_occured = 0x80


def _emit_symbols(block, out: bytearray, hdr: _BitWriter, m: _Model,
                  encoded_ctx: bool):
    """Per-symbol encoding shared by small copies and encoded-copy blocks."""
    third_bits = (0b111, 3) if encoded_ctx else (0b0111, 4)
    for sym in block:
        if sym == m.last_rle:
            hdr.write(0b0, 1)
        elif sym == m.second:
            hdr.write(0b011, 3)
            m.last_occured = sym
        elif sym == m.third:
            hdr.write(*third_bits)
            m.last_occured = sym
        else:
            hdr.write(0b01, 2)
            if sym == m.last_occured:
                m.third = m.second
                m.second = sym
            m.last_occured = sym
            out.append(sym)


def _sh_encoded_copy(data, pos: int, count: int, out: bytearray,
                     hdr: _BitWriter, m: _Model):
    remaining = count
    while remaining:
        if remaining > MIN_ENC_COPY:
            hdr.write(0b1111111, 7)
            stored = min(0xFF, remaining - MIN_ENC_COPY)
            consumed = stored + MIN_ENC_COPY
            out.append(stored)
            _emit_symbols(data[pos:pos + consumed], out, hdr, m,
                          encoded_ctx=True)
            remaining -= consumed
            pos += consumed
        else:
            _emit_symbols(data[pos:pos + remaining], out, hdr, m,
                          encoded_ctx=False)
            return


def _sh_copy(data, pos: int, count: int, out: bytearray, hdr: _BitWriter,
             m: _Model):
    if count > 255 + MIN_COPY:
        hdr.write(0b0111111, 7)
        out += _U32.pack(count - MIN_COPY)
        out += data[pos:pos + count]
    elif count >= MIN_COPY:
        hdr.write(0b0011111, 7)
        out.append(count - MIN_COPY)
        out += data[pos:pos + count]
    else:
        _emit_symbols(data[pos:pos + count], out, hdr, m, encoded_ctx=False)


def sh_compress(data) -> bytes:
    buf = bytes(data) if not isinstance(data, (bytes, bytearray)) else bytes(data)
    n = len(buf)
    if n == 0:
        return b""
    from ..utils import native
    fast = native.sh_encode(buf)     # byte-exact C++ tier (csrc), ~200x
    if fast is not None:
        return fast
    out = bytearray()
    hdr = _BitWriter()
    m = _Model()

    last_symbol = 0
    copy_count = 0
    rle_change_count = 0
    rle_count = 0
    rle_symbol_copy_count = 0
    last_was_same = False
    last_was_copy = False
    block_start = 0

    for i in range(n):
        symbol = buf[i]
        if symbol == m.last_rle:
            if not last_was_same:
                if rle_change_count >= MIN_CHANGE:
                    _sh_copy(buf, block_start, copy_count - rle_change_count,
                             out, hdr, m)
                    block_start += copy_count
                    copy_count = 0
                    m.last_rle = last_symbol
                    hdr.write(0b1011111, 7)
                    out += _U32.pack((rle_change_count - MIN_RLE) & 0xFFFFFFFF)
                    out.append(last_symbol)
                    copy_count = 1
                    rle_symbol_copy_count = 0
                    rle_count = 0
                    last_was_same = False
                    rle_change_count = 1
                else:
                    rle_count = 1
                    rle_symbol_copy_count += 1
                    last_was_same = True
                    rle_change_count = 0
                last_symbol = symbol
            else:
                rle_count += 1
                rle_symbol_copy_count += 1
                if rle_count > MIN_RLE:
                    real_rle_copy = rle_symbol_copy_count - rle_count
                    if real_rle_copy * 7 > (copy_count - real_rle_copy) * 2:
                        _sh_encoded_copy(buf, block_start, copy_count, out,
                                         hdr, m)
                    else:
                        _sh_copy(buf, block_start, copy_count, out, hdr, m)
                    block_start += copy_count
                    copy_count = 0
                    rle_symbol_copy_count = 0
                    last_was_same = True
                    last_was_copy = False
                    last_symbol = symbol
        else:
            if last_was_same and last_was_copy:
                last_was_same = False
                copy_count += rle_count
                rle_count = 0

            if symbol == last_symbol:
                rle_change_count += 1
            else:
                if rle_change_count >= MIN_CHANGE:
                    cc_wo = copy_count - rle_change_count
                    if rle_symbol_copy_count * 7 > (cc_wo - rle_symbol_copy_count) * 2:
                        _sh_encoded_copy(buf, block_start, cc_wo, out, hdr, m)
                    else:
                        _sh_copy(buf, block_start, cc_wo, out, hdr, m)
                    block_start += copy_count
                    copy_count = 0
                    rle_symbol_copy_count = 0
                    m.last_rle = last_symbol
                    hdr.write(0b1011111, 7)
                    out += _U32.pack((rle_change_count - MIN_RLE) & 0xFFFFFFFF)
                    out.append(last_symbol)
                rle_change_count = 1
                last_symbol = symbol

            if not last_was_copy:
                if rle_count > 255 + MIN_RLE:
                    hdr.write(0b1011111, 7)
                    out += _U32.pack(rle_count - MIN_RLE)
                    out.append(m.last_rle)
                elif rle_count >= MIN_RLE:
                    hdr.write(0b01111, 5)
                    out.append(rle_count - MIN_RLE)
                else:
                    for _ in range(rle_count):
                        hdr.write(0b0, 1)
                block_start = i
                copy_count = 1
                rle_count = 0
                rle_symbol_copy_count = 0
                last_was_same = False
                last_was_copy = True
            else:
                copy_count += 1

    if last_was_copy:
        if last_was_same:
            copy_count += rle_count
            rle_count = 0
        _sh_copy(buf, block_start, copy_count, out, hdr, m)
    else:
        if rle_count > 255 + MIN_RLE:
            hdr.write(0b1011111, 7)
            out += _U32.pack(rle_count - MIN_RLE)
            out.append(m.last_rle)
        elif rle_count >= MIN_RLE:
            hdr.write(0b01111, 5)
            out.append(rle_count - MIN_RLE)
        else:
            for _ in range(rle_count):
                hdr.write(0b0, 1)

    hdr.write(0b0111111, 7)          # copy-large terminator
    out += _U32.pack(0)

    head = struct.pack("<II", n, 0)
    body = head + bytes(out) + hdr.finish()
    final = bytearray(body)
    _U32.pack_into(final, 4, len(final))
    return bytes(final)


class _BitReader:
    """Forward bit order over the reversed header bytes."""

    def __init__(self, buf: bytes, hdr_start: int):
        self.bytes = buf[hdr_start:][::-1]
        self.pos = 0
        self.bit = 0

    def read1(self) -> int:
        b = (self.bytes[self.pos] >> self.bit) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.pos += 1
        return b


def sh_decompress(buf) -> bytes:
    buf = bytes(buf)
    usize, csize = struct.unpack_from("<II", buf, 0)
    # the bit header is read backward from the *claimed* compressed size
    # (rle_sh.c:521), not from the end of the caller's buffer
    buf = buf[:csize]
    if usize == 0:
        return b""
    from ..utils import native
    fast = native.sh_decode(buf, len(buf), usize)
    if fast is not None:        # None: lib unavailable or malformed stream
        return fast
    # the bit header sits after the forward stream; its start is not stored,
    # so parse bits from the end backward: reconstruct by scanning from the
    # back while tracking the forward cursor.  We find the header start by
    # decoding: the forward stream length is implied by the parse, so decode
    # with two cursors: p (forward) and bits from the tail.
    out = bytearray()
    m = _Model()
    p = 8

    # The header's byte extent is unknown upfront; read bits lazily from the
    # end of the buffer backward (reversed order = forward write order).
    rbytes = buf[::-1]          # rbytes[0] = last byte of buf
    bpos = 0
    bbit = 0

    def read1():
        nonlocal bpos, bbit
        b = (rbytes[bpos] >> bbit) & 1
        bbit += 1
        if bbit == 8:
            bbit = 0
            bpos += 1
        return b

    def read_prefix():
        ones = 0
        while ones < 5 and read1() == 1:
            ones += 1
        return ones

    while len(out) < usize:
        ones = read_prefix()
        if ones == 0:
            out.append(m.last_rle)
        elif ones == 1:
            sym = buf[p]; p += 1
            if sym == m.last_occured:
                m.third = m.second
                m.second = sym
            m.last_occured = sym
            out.append(sym)
        elif ones == 2:
            out.append(m.second)
            m.last_occured = m.second
        elif ones == 3:
            out.append(m.third)
            m.last_occured = m.third
        elif ones == 4:
            cnt = buf[p] + MIN_RLE; p += 1
            out += bytes([m.last_rle]) * cnt
        else:
            b5 = read1()
            b6 = read1()
            if b6 == 0 and b5 == 0:        # copy small
                cnt = buf[p] + MIN_COPY; p += 1
                out += buf[p:p + cnt]; p += cnt
            elif b6 == 0 and b5 == 1:      # copy large (or terminator)
                v = _U32.unpack_from(buf, p)[0]; p += 4
                if v == 0:
                    break
                cnt = v + MIN_COPY
                out += buf[p:p + cnt]; p += cnt
            elif b6 == 1 and b5 == 0:      # rle large
                v = _U32.unpack_from(buf, p)[0]; p += 4
                sym = buf[p]; p += 1
                m.last_rle = sym
                # uint32 wrap: the encoder stores (count - 14) mod 2^32 even
                # for counts below 14 (rle_sh.c:319), the decoder's uint32
                # addition wraps it back (rle_sh.c:629)
                out += bytes([sym]) * ((v + MIN_RLE) & 0xFFFFFFFF)
            else:                          # encoded copy
                cnt = buf[p] + MIN_ENC_COPY; p += 1
                for _ in range(cnt):
                    if read1() == 0:
                        out.append(m.last_rle)
                    elif read1() == 0:
                        sym = buf[p]; p += 1
                        if sym == m.last_occured:
                            m.third = m.second
                            m.second = sym
                        m.last_occured = sym
                        out.append(sym)
                    elif read1() == 0:
                        out.append(m.second)
                        m.last_occured = m.second
                    else:
                        out.append(m.third)
                        m.last_occured = m.third

    return bytes(out[:usize])
