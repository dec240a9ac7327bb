"""8-bit RLE family: base / Packed, Multi / Single.

Byte-exact reimplementation of the reference formats:

- container header: packed ``{u32 uncompressedLength, u32 compressedLength,
  u8 mode}`` (rle8_extreme_cpu.c:5-15), mode 0 = multi, 1 = single.
- multi (non-packed) command: ``[symbol][storedCount: u8, 0 -> u32]
  [range: u8, 0 -> u32][range-1 literal bytes]`` where a run of ``count``
  repeats of ``symbol`` is emitted when ``count >= 6`` with
  ``storedCount = count - 5`` (rle8_extreme_cpu.h:2-6, 768-931).
- multi packed command: ``[storedCount|sameBit: u8, low7==0 -> u32]
  [symbol if !sameBit][range7: (range<<1) u8 if range<=127 else (range<<1)|1
  u32][range-1 literals]`` with ``storedCount = count - 2`` and the emission
  cost model at rle8_extreme_cpu.h:808-810.
- single: one up-front symbol chosen by an (intentionally approximate)
  SIMD-shaped histogram scan (rle8_extreme_cpu.c:53-153), then
  ``[storedCount][range]`` commands for runs of that symbol only
  (rle8_extreme_cpu.h:346-699).

Encoders walk maximal runs (numpy-extracted); only runs that can meet the
minimum-range thresholds are visited sequentially, so cost is O(#candidate
runs), not O(bytes).
"""

from __future__ import annotations

import struct

import numpy as np

HEADER_SIZE = 9
MODE_MULTI = 0
MODE_SINGLE = 1

# rle8_extreme_cpu.h:2-24
MULTI_MIN_RANGE_SHORT = 6          # non-packed
MULTI_MIN_RANGE_LONG = 9
PACKED_MIN_RANGE_SHORT = 3
PACKED_MIN_RANGE_MEDIUM = 4
PACKED_MIN_RANGE_LONG = 11  # (1+1+4+4+1), rle8_extreme_cpu.h:17
SINGLE_MIN_RANGE_SHORT = 4        # non-packed build
SINGLE_MIN_RANGE_LONG = 8
PACKED_SINGLE_MIN_RANGE_SHORT = 2  # (1+1), rle8_extreme_cpu.h:21
PACKED_SINGLE_MIN_RANGE_LONG = 10  # (1+4+1+4), rle8_extreme_cpu.h:23

_U32 = struct.Struct("<I")


def decompress_additional_size() -> int:
    """Output-buffer slack required because SIMD decoders overshoot
    (rle8_extreme_cpu.c:17-20)."""
    return 128


def compress_bounds(in_size: int) -> int:
    """Worst-case compressed size; rejects > 1 GiB (rle8_extreme_cpu.c:22-28)."""
    if in_size > (1 << 30):
        return 0
    return in_size + (16 + 4 + 1 + 4 + 1 + 64) * 2 + (3 * 4) + 1


def _find_runs(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (starts, lengths) of maximal runs of equal bytes."""
    n = arr.shape[0]
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    change = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    return starts, ends - starts


def _pack_header(uncompressed: int, compressed: int, mode: int) -> bytes:
    return struct.pack("<IIB", uncompressed, compressed, mode)


def _read_header(buf: bytes) -> tuple[int, int, int]:
    uncompressed, compressed, mode = struct.unpack_from("<IIB", buf, 0)
    return uncompressed, compressed, mode


# ---------------------------------------------------------------------------
# multi encoders
# ---------------------------------------------------------------------------

def _emit_multi_plain(out: bytearray, mv: bytes, symbol: int, count: int,
                      rng: int, lit_lo: int, lit_hi: int) -> None:
    stored_count = count - MULTI_MIN_RANGE_SHORT + 1
    out.append(symbol)
    if stored_count <= 255:
        out.append(stored_count)
    else:
        out.append(0)
        out += _U32.pack(stored_count)
    if rng > 255:
        out.append(0)
        out += _U32.pack(rng)
    else:
        out.append(rng)
    out += mv[lit_lo:lit_hi]


def _emit_multi_packed(out: bytearray, mv: bytes, symbol: int, count: int,
                       rng: int, lit_lo: int, lit_hi: int, same: bool) -> None:
    stored_count = count - PACKED_MIN_RANGE_SHORT + 1
    same_bit = 0x80 if same else 0
    if stored_count <= 127:
        out.append(stored_count | same_bit)
    else:
        out.append(same_bit)
        out += _U32.pack(stored_count)
    if not same_bit:
        out.append(symbol)
    if rng <= 127:
        out.append(rng << 1)
    else:
        out += _U32.pack((rng << 1) | 1)
    out += mv[lit_lo:lit_hi]


def _compress_multi_plain(data: np.ndarray) -> bytes:
    """Non-packed multi: vector and scalar loops share the `count >= 6`
    emission condition, so output is a pure function of the maximal runs."""
    n = int(data.shape[0])
    out = bytearray(_pack_header(n, 0, MODE_MULTI))
    mv = data.tobytes()

    starts, lengths = _find_runs(data)
    cand = np.flatnonzero(lengths >= MULTI_MIN_RANGE_SHORT)

    last_rle = 0
    final_run_emitted = False
    for k in cand.tolist():
        s = int(starts[k])
        count = int(lengths[k])
        i = s + count
        rng = s - last_rle + 1
        _emit_multi_plain(out, mv, int(data[s]), count, rng, last_rle, s)
        last_rle = i
        if i == n:
            final_run_emitted = True

    if final_run_emitted:
        out += b"\x00\x00" + _U32.pack(0)   # symbol 0, count escape -> 0
        out += b"\x00" + _U32.pack(0)       # range escape -> 0 (terminator)
    else:
        copy_size = n - last_rle
        out += b"\x00\x00" + _U32.pack(0)
        out.append(0)
        out += _U32.pack(copy_size + 1)
        out += mv[last_rle:]

    _U32.pack_into(out, 4, len(out))
    return bytes(out)


def _compress_multi_packed(data: np.ndarray, vec: int = 32) -> bytes:
    """Packed multi, faithful to the reference's vector/scalar split.

    The vector loop (rle8_extreme_cpu.h:936-1130, AVX2) applies the rich cost
    model at rle8_extreme_cpu.h:978, but the scalar tail loop covering roughly
    the last `vec` bytes only emits runs with ``count >= 10``
    (rle8_extreme_cpu.h:122), and never sets the same-symbol bit
    (rle8_extreme_cpu.h:143-158).  Output therefore depends on the ISA tier;
    ``vec=32`` reproduces the AVX2 build, ``vec=16`` the SSE2 build.
    """
    n = int(data.shape[0])
    out = bytearray(_pack_header(n, 0, MODE_MULTI))
    mv = data.tobytes()
    arr = data

    E = n - vec
    last_rle = 0
    last_symbol = 0
    i = 0
    count = 0
    symbol = (~int(arr[0])) & 0xFF

    if E > 0:
        starts, lengths = _find_runs(arr)
        run_of = np.repeat(np.arange(starts.shape[0]), lengths)
        run_end = (starts + lengths)[run_of]
        rlr = run_end - np.arange(n)          # match length to the right
        eq = arr[1:] == arr[:-1]
        idx = np.where(eq, np.arange(n - 1), n + vec)
        nexteq = np.minimum.accumulate(idx[::-1])[::-1]

        while i < E:
            m = int(rlr[i]) if int(arr[i]) == symbol else 0
            if m >= vec:
                steps_by_len = m // vec
                steps_by_bound = (E - 1 - i) // vec + 1
                f = min(steps_by_len, steps_by_bound)
                count += vec * f
                i += vec * f
                continue
            z = m
            if z > 0 or count > 1:
                count += z
                i += z
                rng = i - last_rle - count + 1
                if count >= PACKED_MIN_RANGE_LONG or (
                    rng <= 127
                    and (
                        (symbol == last_symbol and count >= PACKED_MIN_RANGE_SHORT)
                        or count >= PACKED_MIN_RANGE_MEDIUM
                    )
                ):
                    _emit_multi_packed(out, mv, symbol, count, rng,
                                       last_rle, i - count,
                                       symbol == last_symbol)
                    last_symbol = symbol
                    last_rle = i
            while i < E:
                j = int(nexteq[i]) if i < n - 1 else n + vec
                if j - i >= vec - 1:
                    i += vec - 1
                else:
                    i = j
                    break
            if i >= n:
                break
            symbol = int(arr[i])
            count = 1
            i += 1

    # scalar tail (rle8_extreme_cpu.h:111-200): plain LONG threshold only,
    # same-symbol bit never used.
    while i < n:
        if int(arr[i]) == symbol:
            count += 1
        else:
            if count >= PACKED_MIN_RANGE_LONG:
                rng = i - last_rle - count + 1
                _emit_multi_packed(out, mv, symbol, count, rng,
                                   last_rle, i - count, same=False)
                last_rle = i
            symbol = int(arr[i])
            count = 1
        i += 1

    # flush (rle8_extreme_cpu.h:202-338)
    if count >= PACKED_MIN_RANGE_LONG:
        rng = n - last_rle - count + 1
        _emit_multi_packed(out, mv, symbol, count, rng,
                           last_rle, n - count, same=False)
        out.append(0x80)                    # same-symbol, count escape
        out += _U32.pack(0)
        out += _U32.pack(1)                 # (0 << 1) | 1 -> range 0
    else:
        copy_size = n - last_rle
        out.append(0x80)
        out += _U32.pack(0)
        out += _U32.pack(((copy_size + 1) << 1) | 1)
        out += mv[last_rle:]

    _U32.pack_into(out, 4, len(out))
    return bytes(out)


# ---------------------------------------------------------------------------
# single-symbol selection (rle8_single_compress_get_approx_optimal_symbol_sse2)
# ---------------------------------------------------------------------------

def _approx_optimal_symbol(data: np.ndarray) -> int:
    """Faithful emulation of the reference's approximate SSE2 histogram scan
    (rle8_extreme_cpu.c:53-153), including its idiosyncrasies: the scan stops
    16 bytes before the end, full-vector strides count 15 of every 16 bytes,
    and ``pcount[0]`` starts at ``UINT32_MAX`` when the stream doesn't begin
    with a zero byte."""
    n = int(data.shape[0])
    prob = np.zeros(256, np.uint64)
    pcount = np.zeros(256, np.uint64)
    U32 = np.uint64(0xFFFFFFFF)  # pcount/prob are uint32 in the reference

    if data[0] != 0:
        pcount[0] = 0xFFFFFFFF

    last = (~int(data[0])) & 0xFF
    count = 0
    i = 0
    E = n - 16

    if E > 0:
        arr = data
        # rlr[j] = length of the maximal equal-run starting at j
        starts, lengths = _find_runs(arr)
        run_of = np.repeat(np.arange(starts.shape[0]), lengths)
        run_end = (starts + lengths)[run_of]
        rlr = run_end - np.arange(n)
        # nexteq[j] = smallest k >= j with arr[k] == arr[k+1] (n-1 sentinel)
        eq = arr[1:] == arr[:-1]
        idx = np.where(eq, np.arange(n - 1), n + 16)
        nexteq = np.minimum.accumulate(idx[::-1])[::-1]

        first_window = True
        while i < E:
            m = int(rlr[i]) if int(arr[i]) == last else 0
            if m >= 16:
                # closed-form fast-forward over full-match iterations
                steps_by_len = m // 16
                steps_by_bound = max(0, (E - 1 - i) // 16 + 1)
                f = min(steps_by_len, steps_by_bound)
                count += 15 * f
                i += 16 * f
                first_window = False
                if i >= E or (int(arr[i]) == last and int(rlr[i]) >= 16):
                    continue
                m = int(rlr[i]) if int(arr[i]) == last else 0
            # partial window: z = m
            mask_nonzero = m > 0
            if first_window and not mask_nonzero:
                # at stream start `last` can match bytes beyond a mismatch
                mask_nonzero = bool(np.any(arr[i:i + 16] == last))
            first_window = False
            if mask_nonzero or count > 1:
                count += m
                i += m
                prob[last] += np.uint64(count)
                prob[last] &= U32
                pcount[last] = (pcount[last] + np.uint64(1)) & U32
            # skip-ahead to the next adjacent-equal pair, in 15-byte strides
            while i < E:
                j = int(nexteq[i]) if i < n - 1 else n + 16
                if j - i >= 15:
                    i += 15
                else:
                    i = j
                    break
            count = 1
            last = int(arr[i]) if i < n else last
            i += 1

    prob[last] = (prob[last] + np.uint64(count)) & U32
    pcount[last] = (pcount[last] + np.uint64(1)) & U32

    best_saved = 0
    best_sym = 0
    for sym in range(256):
        pc = int(pcount[sym])
        if pc > 0 and int(prob[sym]) // pc > 2:
            saved = int(prob[sym]) - pc * 2
            if saved > best_saved:
                best_saved = saved
                best_sym = sym
    return best_sym


def _compress_single(data: np.ndarray, packed: bool = False) -> bytes:
    n = int(data.shape[0])
    min_short = PACKED_SINGLE_MIN_RANGE_SHORT if packed else SINGLE_MIN_RANGE_SHORT
    min_long = PACKED_SINGLE_MIN_RANGE_LONG if packed else SINGLE_MIN_RANGE_LONG
    symbol = _approx_optimal_symbol(data)
    out = bytearray(_pack_header(n, 0, MODE_SINGLE))
    out.append(symbol)
    mv = data.tobytes()

    starts, lengths = _find_runs(data)
    is_sym = data[starts] == symbol
    cand = np.flatnonzero(is_sym & (lengths >= min_short))

    last_rle = 0
    final_case = None  # set when the flush handles the trailing run

    for k in cand.tolist():
        s = int(starts[k])
        count = int(lengths[k])
        i = s + count
        rng = i - last_rle - count + 1

        if i == n:
            break  # flush handles the trailing run

        if rng <= 255 and count >= min_short:
            stored_count = count - min_short + 1
            if stored_count <= 255:
                out.append(stored_count)
            else:
                out.append(0)
                out += _U32.pack(stored_count)
            out.append(rng)
            out += mv[last_rle:s]
            last_rle = i
        elif count >= min_long:
            stored_count = count - min_short + 1
            if stored_count <= 255:
                out.append(stored_count)
            else:
                out.append(0)
                out += _U32.pack(stored_count)
            out.append(0)
            out += _U32.pack(rng)
            out += mv[last_rle:s]
            last_rle = i

    # flush (rle8_extreme_cpu.h:512-694); `count` = trailing run of `symbol`
    count = 0
    if n and int(data[-1]) == symbol:
        count = int(lengths[-1])
    i = n
    rng = i - last_rle - count + 1

    if rng <= 255 and count >= min_short:
        stored_count = count - min_short + 1
        if stored_count <= 255:
            out.append(stored_count)
        else:
            out.append(0)
            out += _U32.pack(stored_count)
        out.append(rng)
        out += mv[last_rle:i - count]
        out += b"\x00" + _U32.pack(0)
        out += b"\x00" + _U32.pack(0)
    elif count >= min_long:
        stored_count = count - min_short + 1
        if stored_count <= 255:
            out.append(stored_count)
        else:
            out.append(0)
            out += _U32.pack(stored_count)
        out.append(0)
        out += _U32.pack(rng)
        out += mv[last_rle:i - count]
        out += b"\x00" + _U32.pack(0)
        out += b"\x00" + _U32.pack(0)
    else:
        out += b"\x00" + _U32.pack(0)
        out.append(0)
        out += _U32.pack(rng + count)
        out += mv[last_rle:]

    _U32.pack_into(out, 4, len(out))
    return bytes(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def rle8_compress(data, *, packed: bool = False, single: bool = False) -> bytes:
    """Compress with the 8-bit RLE family.

    Mirrors ``rle8_multi_compress`` / ``rle8_packed_multi_compress`` /
    ``rle8_single_compress`` / ``rle8_packed_single_compress`` (rle.h:57-78).
    The packed compilation unit also redefines the single-mode thresholds
    (rle8_extreme_cpu.h:19-23): SHORT=2, LONG=10 vs the plain build's 4/8, so
    packed+single is a distinct byte stream despite sharing the layout.
    """
    arr = np.frombuffer(memoryview(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, dtype=np.uint8)
    if arr.size == 0 or arr.size > (1 << 30):
        return b""
    if single:
        return _compress_single(arr, packed=packed)
    if packed:
        return _compress_multi_packed(arr)
    return _compress_multi_plain(arr)


def rle8_decompress(buf, *, packed: bool = False) -> bytes:
    """Decompress an 8-bit RLE stream (multi or single mode, from the header).

    Mirrors ``rle8_decompress`` / ``rle8_packed_decompress``
    (rle8_extreme_cpu.h:702-764). Vectorized over commands on the host.
    """
    buf = bytes(buf)
    uncompressed, compressed, mode = _read_header(buf)
    out = bytearray(uncompressed + decompress_additional_size())
    pos = 0  # output write cursor
    p = HEADER_SIZE

    if mode == MODE_MULTI:
        if not packed:
            while True:
                symbol = buf[p]; p += 1
                stored_count = buf[p]; p += 1
                if stored_count == 0:
                    stored_count = _U32.unpack_from(buf, p)[0]; p += 4
                rng = buf[p]; p += 1
                if rng == 0:
                    rng = _U32.unpack_from(buf, p)[0]; p += 4
                    if rng == 0:
                        break
                rng -= 1
                out[pos:pos + rng] = buf[p:p + rng]
                p += rng; pos += rng
                if stored_count == 0:
                    break
                count = stored_count + MULTI_MIN_RANGE_SHORT - 1
                out[pos:pos + count] = bytes([symbol]) * count
                pos += count
        else:
            symbol = 0
            while True:
                b0 = buf[p]; p += 1
                same = b0 & 0x80
                stored_count = b0 & 0x7F
                if stored_count == 0:
                    stored_count = _U32.unpack_from(buf, p)[0]; p += 4
                if not same:
                    symbol = buf[p]; p += 1
                r0 = buf[p]
                if r0 & 1:
                    rng = _U32.unpack_from(buf, p)[0] >> 1; p += 4
                    if rng == 0:
                        break
                else:
                    rng = r0 >> 1; p += 1
                rng -= 1
                out[pos:pos + rng] = buf[p:p + rng]
                p += rng; pos += rng
                if stored_count == 0:
                    break
                count = stored_count + PACKED_MIN_RANGE_SHORT - 1
                out[pos:pos + count] = bytes([symbol]) * count
                pos += count
    elif mode == MODE_SINGLE:
        symbol = buf[p]; p += 1
        run = None
        while True:
            stored_count = buf[p]; p += 1
            if stored_count == 0:
                stored_count = _U32.unpack_from(buf, p)[0]; p += 4
            rng = buf[p]; p += 1
            if rng == 0:
                rng = _U32.unpack_from(buf, p)[0]; p += 4
                if rng == 0:
                    break
            rng -= 1
            out[pos:pos + rng] = buf[p:p + rng]
            p += rng; pos += rng
            if stored_count == 0:
                break
            count = stored_count + (
                PACKED_SINGLE_MIN_RANGE_SHORT if packed
                else SINGLE_MIN_RANGE_SHORT) - 1
            if run is None or len(run) < count:
                run = bytes([symbol]) * max(count, 4096)
            out[pos:pos + count] = run[:count]
            pos += count
    else:
        return b""

    return bytes(out[:uncompressed])
