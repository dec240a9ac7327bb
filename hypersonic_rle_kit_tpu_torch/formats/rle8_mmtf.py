"""RLE8 MMTF 128: MTF-transformed blocks + RLE + 2/3/4-bit bitpacking
(rle8_mmtf.c; the 256-bit variant is declared but stubbed in the reference,
rle8_mmtf.c:1295-1297).

The input is passed through the 16-lane MTF-of-256 transform (as in mmtf.c);
the transformed stream is split into 16-byte blocks and classified on the
fly (rle8_mmtf.c:190-446):

- runs of blocks whose 16 MTF indices are all one value -> RLE command
  ``[count<<1 (u8, count<128) | count<<1|1 (u32)][symbol]``;
- copy regions -> ``[count<<3 | flags (u8, count<32) | count<<3|1|flags
  (u32)]`` + the raw index blocks, or bitpacked when every index in the
  region fits: flags 0b110 -> 2-bit, 0b100 -> 3-bit, 0b010 -> 4-bit, 0b000 ->
  raw (bitpack layouts per bitpack_encode{2,3}_simple / encode4,
  rle8_mmtf.c:45-149, bitpack.h:793-825);
- the stream alternates copy, RLE, copy, ... with zero-count commands as
  connectors/terminators; trailing bytes (< 16) are MTF-index encoded with
  the final histories, without updating them (rle8_mmtf.c:629-643).
"""

from __future__ import annotations

import struct

import numpy as np

_U32 = struct.Struct("<I")


def compress_bounds(in_size: int) -> int:
    if in_size > (1 << 30):
        return 0
    return in_size + 1 + 1 + 1 + 4 + 1


def _mtf_transform(arr: np.ndarray):
    """16-lane MTF over full blocks; returns (transformed full blocks, tail
    index bytes, i.e. the reference's post-loop per-lane lookups)."""
    n = int(arr.size)
    full = n // 16 * 16
    out = np.empty(full, np.uint8)
    hists = []
    for lane in range(16):
        hist = list(range(256))
        idx = hist.index
        seq = arr[lane:full:16]
        res = np.empty(seq.size, np.uint8)
        for k, v in enumerate(seq.tolist()):
            d = idx(v)
            res[k] = d
            if d:
                del hist[d]
                hist.insert(0, v)
        out[lane:full:16] = res
        hists.append(hist)
    tail = bytes(hists[i - full].index(int(arr[i])) for i in range(full, n))
    return out.reshape(-1, 16), tail, hists


def _pack2(blocks: np.ndarray) -> bytes:
    """bitpack_encode2_simple: 4-block groups lane-wise, then per-block
    4xu32 words (rle8_mmtf.c:45-85)."""
    out = bytearray()
    g = blocks.shape[0] // 4 * 4
    if g:
        b = blocks[:g].reshape(-1, 4, 16).astype(np.uint16)
        packed = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6))
        out += packed.astype(np.uint8).tobytes()
    for k in range(g, blocks.shape[0]):
        w = blocks[k].astype(np.uint32)
        for j in range(4):
            out.append(int(w[j] | (w[4 + j] << 2) | (w[8 + j] << 4)
                           | (w[12 + j] << 6)) & 0xFF)
    return bytes(out)


def _pack3(blocks: np.ndarray) -> bytes:
    """bitpack_encode3_simple (rle8_mmtf.c:91-149)."""
    out = bytearray()
    g = blocks.shape[0] // 6 * 6
    if g:
        b = blocks[:g].reshape(-1, 6, 16).astype(np.uint16)
        for grp in b:
            a = (grp[0] | (grp[1] << 3) | ((grp[2] & 3) << 6)) & 0xFF
            c = (grp[3] | (grp[4] << 3) | ((grp[5] & 3) << 6)) & 0xFF
            out += a.astype(np.uint8).tobytes()
            out += c.astype(np.uint8).tobytes()
            m2 = int(np.bitwise_or.reduce(
                ((grp[2] >> 2) & 1).astype(np.uint32) << np.arange(16)))
            m5 = int(np.bitwise_or.reduce(
                ((grp[5] >> 2) & 1).astype(np.uint32) << np.arange(16)))
            out += _U32.pack(m2 | (m5 << 16))
    for k in range(g, blocks.shape[0]):
        blk = blocks[k].astype(np.uint32)
        for bit in range(3):
            m = int(np.bitwise_or.reduce(((blk >> bit) & 1) << np.arange(16)))
            out += struct.pack("<H", m)
    return bytes(out)


def _pack4(blocks: np.ndarray) -> bytes:
    """bitpack_encode4 (bitpack.h:793-825): block pairs hi|lo nibbles."""
    out = bytearray()
    g = blocks.shape[0] // 2 * 2
    if g:
        b = blocks[:g].reshape(-1, 2, 16).astype(np.uint16)
        packed = ((b[:, 0] << 4) | b[:, 1]) & 0xFF
        out += packed.astype(np.uint8).tobytes()
    if blocks.shape[0] > g:
        blk = blocks[-1].astype(np.uint32)
        for j in range(8):
            out.append(int(blk[j] | (blk[8 + j] << 4)) & 0xFF)
    return bytes(out)


def _unpack2(buf: bytes, p: int, count: int):
    blocks = np.empty((count, 16), np.uint8)
    g = count // 4 * 4
    for k in range(0, g, 4):
        raw = np.frombuffer(buf, np.uint8, 16, p); p += 16
        for q in range(4):
            blocks[k + q] = (raw >> (2 * q)) & 3
    for k in range(g, count):
        raw = np.frombuffer(buf, np.uint8, 4, p); p += 4
        w = np.empty(16, np.uint8)
        for q in range(4):
            w[4 * q:4 * q + 4] = (raw >> (2 * q)) & 3
        blocks[k] = w
    return blocks, p


def _unpack3(buf: bytes, p: int, count: int):
    blocks = np.empty((count, 16), np.uint8)
    g = count // 6 * 6
    for k in range(0, g, 6):
        a = np.frombuffer(buf, np.uint8, 16, p); p += 16
        c = np.frombuffer(buf, np.uint8, 16, p); p += 16
        m = _U32.unpack_from(buf, p)[0]; p += 4
        b2 = np.array([(m >> j) & 1 for j in range(16)], np.uint8)
        b5 = np.array([(m >> (16 + j)) & 1 for j in range(16)], np.uint8)
        blocks[k] = a & 7
        blocks[k + 1] = (a >> 3) & 7
        blocks[k + 2] = ((a >> 6) & 3) | (b2 << 2)
        blocks[k + 3] = c & 7
        blocks[k + 4] = (c >> 3) & 7
        blocks[k + 5] = ((c >> 6) & 3) | (b5 << 2)
    for k in range(g, count):
        m0, m1, m2 = struct.unpack_from("<HHH", buf, p); p += 6
        blk = np.zeros(16, np.uint8)
        for j in range(16):
            blk[j] = (((m0 >> j) & 1) | (((m1 >> j) & 1) << 1)
                      | (((m2 >> j) & 1) << 2))
        blocks[k] = blk
    return blocks, p


def _unpack4(buf: bytes, p: int, count: int):
    blocks = np.empty((count, 16), np.uint8)
    g = count // 2 * 2
    for k in range(0, g, 2):
        raw = np.frombuffer(buf, np.uint8, 16, p); p += 16
        blocks[k] = (raw >> 4) & 0xF
        blocks[k + 1] = raw & 0xF
    if count > g:
        raw = np.frombuffer(buf, np.uint8, 8, p); p += 8
        w = np.empty(16, np.uint8)
        w[:8] = raw & 0xF
        w[8:] = (raw >> 4) & 0xF
        blocks[-1] = w
    return blocks, p


def _emit_copy(out: bytearray, blocks: list[np.ndarray], mask: np.ndarray):
    count = len(blocks)
    if np.all(mask < 4):
        flags = 0b110
        pack = _pack2
    elif np.all(mask < 8):
        flags = 0b100
        pack = _pack3
    elif np.all(mask < 16):
        flags = 0b010
        pack = _pack4
    else:
        flags = 0
        pack = None
    if count < 32:
        out.append(((count << 3) | flags) & 0xFF)
    else:
        out += _U32.pack((count << 3) | 1 | flags)
    if count:
        arr = np.stack(blocks)
        out += pack(arr) if pack else arr.tobytes()


def _emit_rle(out: bytearray, count: int, symbol: int):
    if count < 128:
        out.append((count << 1) & 0xFF)
        out.append(symbol)
    else:
        out += _U32.pack((count << 1) | 1)
        out.append(symbol)


def mmtf_rle_compress(data) -> bytes:
    arr = (np.frombuffer(memoryview(data), dtype=np.uint8)
           if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n = int(arr.size)
    if n == 0 or n > (1 << 30):
        return b""
    blocks, tail, _hists = _mtf_transform(arr)

    out = bytearray(struct.pack("<II", n, 0))
    copying = True
    count = 0
    symbol = 0
    cur: list[np.ndarray] = []
    # the reference's currentBitMask starts uninitialized
    # (_mm_undefined_si128, rle8_mmtf.c:182); in practice it reads as zero
    mask = np.zeros(16, np.uint8)

    for blk in blocks:
        if copying:
            if (blk == blk[0]).all():
                _emit_copy(out, cur, mask)
                symbol = int(blk[0])
                count = 1
                copying = False
                cur = []
            else:
                mask = mask | blk
                count += 1
                cur.append(blk)
        else:
            if (blk == symbol).all():
                count += 1
            else:
                _emit_rle(out, count, symbol)
                if (blk == blk[0]).all():
                    out.append(0)            # null copy
                    symbol = int(blk[0])
                    count = 1
                else:
                    count = 1
                    cur = [blk]
                    mask = blk.copy()
                    copying = True

    if copying:
        _emit_copy(out, cur, mask)
        out.append(0)                        # null rle
    else:
        _emit_rle(out, count, symbol)
        out.append(0)                        # null copy
        out.append(0)                        # null rle
    out += tail

    _U32.pack_into(out, 4, len(out))
    return bytes(out)


def _mtf_decode_block(indices: np.ndarray, hists: list[list[int]]) -> bytes:
    vals = bytearray(16)
    for lane in range(16):
        hist = hists[lane]
        d = int(indices[lane])
        v = hist[d]
        vals[lane] = v
        if d:
            del hist[d]
            hist.insert(0, v)
    return bytes(vals)


def mmtf_rle_decompress(buf) -> bytes:
    buf = bytes(buf)
    usize, _csize = struct.unpack_from("<II", buf, 0)
    if usize == 0:
        return b""
    p = 8
    out = bytearray()
    hists = [list(range(256)) for _ in range(16)]
    total_blocks = usize // 16

    nblocks = 0
    while nblocks < total_blocks:
        # copy part
        b0 = buf[p]
        if b0 & 1:
            cnt = _U32.unpack_from(buf, p)[0] >> 3; p += 4
        else:
            cnt = b0 >> 3; p += 1
        flags = b0 & 0b110
        if cnt:
            if flags == 0b110:
                blks, p = _unpack2(buf, p, cnt)
            elif flags == 0b100:
                blks, p = _unpack3(buf, p, cnt)
            elif flags == 0b010:
                blks, p = _unpack4(buf, p, cnt)
            else:
                blks = np.frombuffer(buf, np.uint8, cnt * 16, p
                                     ).reshape(cnt, 16)
                p += cnt * 16
            for blk in blks:
                out += _mtf_decode_block(blk, hists)
            nblocks += cnt
        if nblocks >= total_blocks:
            break
        # rle part
        r0 = buf[p]
        if r0 & 1:
            cnt = _U32.unpack_from(buf, p)[0] >> 1; p += 4
        else:
            cnt = r0 >> 1; p += 1
        sym = buf[p]; p += 1
        idxvec = np.full(16, sym, np.uint8)
        for _ in range(cnt):
            out += _mtf_decode_block(idxvec, hists)
        nblocks += cnt

    # trailing bytes: history lookup without update
    rest = usize - total_blocks * 16
    # skip any residual terminator bytes: the tail begins `rest` bytes
    # before the end of the compressed stream
    tail_start = _csize_tail(buf, rest)
    for i in range(rest):
        lane = i
        out.append(hists[lane][buf[tail_start + i]])
    return bytes(out[:usize])


def _csize_tail(buf: bytes, rest: int) -> int:
    csize = struct.unpack_from("<I", buf, 4)[0]
    return csize - rest
