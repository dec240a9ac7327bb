"""Hopper kernels vs their plain torch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  Run them on a
machine with an H100 (``--noconftest``: the suite's conftest only
configures JAX, which these tests do not use):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Integers throughout: kernel and plain version must agree byte for byte.
"""

import json
import sys

import numpy as np
import pytest
import torch

from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.ops import (_kernels, decode_sup, device,
                                              encode_sup, low_entropy_device,
                                              micro_word, mmtf_device, planar,
                                              ref_device, unpack_device)
from hypersonic_rle_kit_tpu_torch.parallel import container
from hypersonic_rle_kit_tpu_torch.utils import native

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dct(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(-4, 5, n).astype(np.int8).astype(np.uint8)
    d[rng.random(n) < 0.8] = 0
    return d


def _blocks(kind, B, nb, seed):
    """[nb, B] input blocks of one edge case -> (x, block_len, only_sym or
    None, min_count); x is zero past each block's length."""
    rng = np.random.default_rng(seed)
    lens = np.full(nb, B, np.int32)
    only_sym, min_count = None, 6
    if kind == "dense":
        x = np.repeat(rng.integers(0, 251, (nb, B // 6 + 1)), 6,
                      axis=1)[:, :B].astype(np.uint8)
    elif kind in ("sparse", "min_count_4"):
        x = _dct(nb * B, seed).reshape(nb, B)
        min_count = 6 if kind == "sparse" else 4
    elif kind == "all_literal":
        x = rng.integers(0, 256, (nb, B), dtype=np.uint8)
    elif kind == "whole_run":
        x = np.repeat(rng.integers(0, 256, (nb, 1), dtype=np.uint8), B, 1)
    elif kind == "ragged_tail":
        x = _dct(nb * B, seed).reshape(nb, B)
        lens[-3:] = [B - 777, 17, 0][-min(3, nb):]
    elif kind == "single":
        # a long run of another byte must become literals
        x = _dct(nb * B, seed).reshape(nb, B)
        x[:, B // 4:B // 2] = 9
        only_sym = np.resize(np.array([0, 9, 3, -1], np.int32), nb)
    elif kind == "min_count_1":
        x = rng.integers(0, 2, (nb, B), dtype=np.uint8)
        x[0] = np.arange(B) % 2          # n_cmds = B + 1, near capacity
        min_count = 1
    else:
        raise ValueError(kind)
    for b in range(nb):
        x[b, lens[b]:] = 0
    return x, lens, only_sym, min_count


def _columns(kind, B, nb, seed):
    """Synthetic planar columns [nb, ...] for one edge case."""
    x, lens, only_sym, min_count = _blocks(kind, B, nb, seed)
    cap = planar.capacity_for(B, min_count)
    outs = [planar.host_encode_block(
        x[b, :lens[b]], cap, B, min_count,
        None if only_sym is None else int(only_sym[b]))
        for b in range(nb)]
    cols = [np.stack([o[i] for o in outs]) for i in range(4)]
    return cols + [np.array([o[i] for o in outs], np.int32)
                   for i in (4, 5)] + [lens]


def _zero_count_columns(B, nb, seed):
    """Random command streams with zero-count commands mid-stream."""
    rng = np.random.default_rng(seed)
    C = 512
    sym = rng.integers(0, 256, (nb, C), dtype=np.uint8)
    count = np.where(rng.random((nb, C)) < 0.3, 0,
                     rng.integers(1, 40, (nb, C))).astype(np.int32)
    lit_len = rng.integers(0, 12, (nb, C)).astype(np.int32)
    n_cmds = rng.integers(1, C, nb).astype(np.int32)
    for b in range(nb):
        count[b, n_cmds[b] - 1:] = 0
        lit_len[b, n_cmds[b]:] = 0
    blen = np.minimum((count + lit_len).sum(1), B).astype(np.int32)
    n_lits = lit_len.sum(1).astype(np.int32)
    lits = rng.integers(0, 256, (nb, B), dtype=np.uint8)
    return [sym, count, lit_len, lits, n_cmds, n_lits, blen]


def _trim_lits(cols):
    lw = max(128, -(-int(cols[5].max()) // 128) * 128)
    cols[3] = decode_sup.lits_to_words(
        np.ascontiguousarray(cols[3][:, :min(lw, cols[3].shape[1])]))
    return cols


CASES = ["dense", "sparse", "all_literal", "whole_run", "ragged_tail",
         "min_count_1", "zero_count_mid"]


@pytest.mark.parametrize("B", [4096, 65536, 262144])
@pytest.mark.parametrize("kind", CASES)
def test_decode_kernel_matches_plain(dev, kind, B):
    nb = 4
    cols = (_zero_count_columns(B, nb, 3) if kind == "zero_count_mid"
            else _columns(kind, B, nb, 5))
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in _trim_lits(cols)]
    for words in (True, False):
        k = decode_sup.decode_columns_device(*t, block_size=B,
                                             out_words=words)
        p = decode_sup.decode_columns_plain(*t, block_size=B,
                                            out_words=words)
        torch.cuda.synchronize()
        assert torch.equal(k, p), (kind, B, words)


def test_decode_kernel_odd_block_size(dev):
    B = 4099
    cols = _columns("sparse", B, 3, 9)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in cols]
    k = decode_sup.decode_columns_device(*t, block_size=B)
    p = decode_sup.decode_columns_plain(*t, block_size=B)
    assert k.shape == (3, B) and torch.equal(k, p)


def _deep_blob(seed):
    rng = np.random.default_rng(seed)
    data = np.zeros(300_000, np.uint8)
    pos = 0
    k = 0
    while pos < data.size - 400:
        run = int(rng.integers(6, 600))
        data[pos:pos + run] = k % 37
        k += 1
        pos += run + int(rng.integers(0, 9))
    raw = data.tobytes()
    return api.compress(raw, block_size=65536, backend="host",
                        device="cpu"), raw


def _dct_blob(seed):
    raw = _dct(300_000, seed).tobytes()
    return api.compress(raw, block_size=65536, backend="host",
                        device="cpu"), raw


def _flat_blob(seed):
    raw = np.frombuffer(_deep_blob(seed)[1], np.uint8)
    B = 65536
    x, lens = api._to_blocks(raw, B)
    cap = planar.capacity_for(B, 6)
    outs = [planar.host_encode_block(x[b, :lens[b]], cap, B, 6)
            for b in range(x.shape[0])]
    cols = ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])
    return container.serialize_blocks(0, raw.size, B, 6, *cols,
                                      deep=False), raw.tobytes()


def _pack_case(kind):
    blob = {"deep": lambda: _deep_blob(1)[0],
            "deep_litdict": lambda: _dct_blob(3)[0],
            "flat": lambda: _flat_blob(1)[0],
            "tampered": lambda: _deep_blob(4)[0]}[kind]()
    pk = container.pack_for_device(blob)
    assert pk["info"].deep == (kind != "flat")
    if kind == "tampered":
        pk["n_cnt_ovf"][0] += 1
        pk["n_miss"][-1] += 2
    return pk


def _same(k, p):
    for x, y in zip(k, p):
        assert (x is None and y is None) or (
            x.dtype == y.dtype and torch.equal(x, y))


@pytest.mark.parametrize("kind", ["deep", "deep_litdict", "flat",
                                  "tampered"])
def test_resolve_kernel_matches_plain(dev, kind):
    """hrt1_unpack_resolve == its plain version on shipped sections; the
    tampered container's bad flags are set and equal."""
    pk = _pack_case(kind)
    args, kw = unpack_device.section_args(pk, unpack_device.ship_packed(pk, dev))
    k = unpack_device.unpack_resolve(*args, **kw)
    p = unpack_device.unpack_resolve_plain(*args, **kw)
    torch.cuda.synchronize()
    _same(k, p)
    if kind == "tampered":
        assert k[3][0] == 1 and k[3][-1] == 1


# (cnt_bits, lit_bits, cnt_ovf_bits, ll_ovf_bits): each of 0, 1, 7, 8, 25
UNPACK_WIDTHS = [(0, 1, 7, 8), (1, 7, 8, 25), (7, 8, 25, 0), (8, 25, 0, 1),
                 (25, 0, 1, 7), (6, 4, 8, 8)]


def _random_sections(widths, cap, seed, dev, nb=6, pad=4):
    """Random packed bytes of each width (rows ``pad`` bytes past the last
    value, so rows sit on no 16-byte boundary), hostile n_cmds -1, 0, 1,
    mid, cap, 2 cap, random stored populations."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def sec(w):
        return t(rng.integers(0, 256, (nb, (w * cap + 7) // 8 + pad),
                              dtype=np.uint8))

    cb, lb, cob, lob = widths
    n_cmds = np.resize(np.array([-1, 0, 1, cap // 2 + 3, cap, 2 * cap],
                                np.int32), nb)
    args = (sec(cb), sec(lb), t(n_cmds))
    kw = dict(cnt_ovf_raw=sec(cob), ll_ovf_raw=sec(lob), lut_raw=sec(3),
              miss_raw=t(rng.integers(0, 256, (nb, cap), dtype=np.uint8)),
              dict7=t(rng.integers(0, 256, (nb, 7), dtype=np.uint8)),
              **{k: t(rng.integers(0, 40, nb, dtype=np.int32))
                 for k in ("n_cnt_ovf", "n_ll_ovf", "n_miss")},
              cnt_bits=cb, lit_bits=lb, cnt_ovf_bits=cob, ll_ovf_bits=lob,
              capacity=cap, min_count=6)
    return args, kw


@pytest.mark.parametrize("cap", [8, 4096, 43776, 5000 * 8])
@pytest.mark.parametrize("widths", UNPACK_WIDTHS, ids=str)
def test_unpack_resolve_random_sections(dev, widths, cap):
    """Every width, capacities of one thread's 8 entries, one sweep and
    several, unaligned rows: kernel == plain, deep and flat."""
    used = (widths[0] * cap + 7) // 8
    # rows off and on 16-byte boundaries (the count section's)
    for pad in (4, -(-(used + 4) // 16) * 16 - used):
        args, kw = _random_sections(widths, cap, cap + pad, dev, pad=pad)
        _same(unpack_device.unpack_resolve(*args, **kw),
              unpack_device.unpack_resolve_plain(*args, **kw))
        flat = {k: kw[k] for k in ("cnt_bits", "lit_bits", "capacity",
                                   "min_count")}
        _same(unpack_device.unpack_resolve(*args, **flat),
              unpack_device.unpack_resolve_plain(*args, **flat))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["deep", "flat"])
def test_dispatch_packed_four_device_ops(dev, kind):
    """A dispatch is hrt1_unpack_resolve, the zeroing of hrt1_decode's
    look-back state and hrt1_decode's two grids: at most 4 nodes a call in
    a captured CUDA graph (utils.cuda_timing.graph_ops)."""
    from hypersonic_rle_kit_tpu_torch.utils.cuda_timing import graph_ops
    pk = _pack_case(kind)
    arrs = unpack_device.ship_packed(pk, dev)
    api.reset_kernel_launch_counts()
    ops = graph_ops(lambda: unpack_device.dispatch_packed(
        pk, arrs, out_words=True))
    assert ops <= 4, ops
    n = api.kernel_launch_counts()
    assert n["hrt1_unpack_resolve"] == n["hrt1_decode"] == 4


def test_decompress_on_card_counts_launches(dev):
    blob, raw = _deep_blob(2)
    api.reset_kernel_launch_counts()
    assert api.decompress(blob, device=dev) == raw
    n = api.kernel_launch_counts()
    assert n["hrt1_decode"] >= 1 and n["hrt1_unpack_resolve"] >= 1


def test_kernels_survive_hostile_columns(dev):
    """Columns no container would hold (negative and huge fields, n_cmds
    and block_len out of range, dense escapes) must not fault; the decode
    stays zero past each block's length, and hrt1_unpack_resolve on random
    packed bytes with n_cmds -1, 0, 1, cap, 2 cap equals its plain
    version, bad flags included."""
    rng = np.random.default_rng(17)
    nb, C, B = 6, 384, 8192
    big = np.iinfo(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cols = [rng.integers(0, 256, (nb, C), dtype=np.uint8),
            rng.integers(big.min, big.max, (nb, C), dtype=np.int32),
            rng.integers(-50, 5000, (nb, C), dtype=np.int32),
            rng.integers(0, 256, (nb, 1000), dtype=np.uint8),
            np.array([-3, 0, 1, C // 2, C, 10 * C], np.int32),
            rng.integers(0, B, nb, dtype=np.int32),
            np.array([B, -7, 0, B // 3, B + 99, 5], np.int32)]
    cols[1][::2] = rng.integers(0, 40, (nb, C))[::2]
    out = decode_sup.decode_columns_device(*map(t, cols), block_size=B)
    torch.cuda.synchronize()
    for b, bl in enumerate(np.clip(cols[6], 0, B)):
        assert not out[b, bl:].any()

    cap = 256
    args, kw = _random_sections((2, 2, 8, 3), cap, 17, dev, nb=5)
    args = (*args[:2], t(np.array([-1, 0, 1, cap, 2 * cap], np.int32)))
    k = unpack_device.unpack_resolve(*args, **kw)
    p = unpack_device.unpack_resolve_plain(*args, **kw)
    torch.cuda.synchronize()
    _same(k, p)


def test_kernel_rejects_bad_input(dev):
    cols = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in _columns("sparse", 4096, 2, 1)]
    cols[1] = cols[1].to(torch.int64)
    with pytest.raises(TypeError):
        decode_sup.decode_columns_device(*cols, block_size=4096)
    assert all(_kernels.lib(n) is not None for n in _kernels.LIBRARIES)


# ---------------------------------------------------------------------------
# hrt1_encode and the device compress path
# ---------------------------------------------------------------------------

ENCODE_CASES = ["dense", "sparse", "all_literal", "whole_run", "ragged_tail",
                "single", "min_count_1", "min_count_4"]


@pytest.mark.parametrize("B", [4096, 65536, 196608, 262144])
@pytest.mark.parametrize("kind", ENCODE_CASES)
def test_encode_kernel_matches_plain(dev, kind, B):
    x, lens, only_sym, min_count = _blocks(kind, B, 4, 7)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    kw = dict(capacity=planar.capacity_for(B, min_count),
              min_count=min_count, only_sym=t(only_sym))
    k = encode_sup.encode_blocks_kernel(t(x), t(lens), **kw)
    pb = device.encode_blocks(t(x), t(lens), **kw)
    p = (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)
    torch.cuda.synchronize()
    for name, a, b in zip(("sym", "count", "lit_len", "lits", "n_cmds",
                           "n_lits"), k, p):
        assert a.dtype == b.dtype and torch.equal(a, b), (kind, B, name)


def test_encode_kernel_odd_block_and_unaligned(dev):
    """A block size that is no multiple of 16 and a row view that is not
    16-byte aligned take the byte-wise loads and stores."""
    x, lens, _, _ = _blocks("sparse", 4099, 3, 2)
    base = torch.from_numpy(x.reshape(-1)).to(dev)
    for xt in (base.view(3, 4099), base[1:1 + 3 * 4096].view(3, 4096)):
        bl = torch.full((3,), xt.shape[1] - 5, dtype=torch.int32, device=dev)
        kw = dict(capacity=planar.capacity_for(xt.shape[1], 6))
        k = encode_sup.encode_blocks_kernel(xt, bl, **kw)
        pb = device.encode_blocks(xt, bl, **kw)
        for a, b in zip(k, (pb.sym, pb.count, pb.lit_len, pb.lits,
                            pb.n_cmds, pb.n_lits)):
            assert torch.equal(a, b)


def test_encode_kernel_rejects_overflow_and_bad_lengths(dev):
    x = torch.from_numpy(np.arange(4096) % 2).to(torch.uint8).to(dev)[None]
    bl = torch.tensor([4096], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="capacity"):
        encode_sup.encode_blocks_kernel(x, bl, capacity=256, min_count=1)
    with pytest.raises(ValueError, match="block_len"):
        encode_sup.encode_blocks_kernel(x, bl + 1, capacity=8192)
    with pytest.raises(TypeError):
        encode_sup.encode_blocks_kernel(x, bl.long(), capacity=8192)


# ---------------------------------------------------------------------------
# the tiled designs of hrt1_encode and hrt1_decode (16 KiB tiles)
# ---------------------------------------------------------------------------

TILE = 16384


def _tile_spanning(B, nb, seed):
    """Literals with runs across every 16 KiB tile edge (1..12 bytes on
    each side: emitted or not at min_count 6), a run over two tiles and a
    literal stretch over two, block_len ending mid-tile."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (nb, B), dtype=np.uint8)
    for b in range(nb):
        for k, edge in enumerate(range(TILE, B, TILE)):
            lo, hi = int(rng.integers(1, 13)), int(rng.integers(1, 13))
            x[b, edge - lo:edge + hi] = (b + k) % 251
        if B > 3 * TILE:
            x[b, TILE - 5:3 * TILE + 7] = 0
    lens = np.array([B - (b * 4099) % min(TILE, B) for b in range(nb)],
                    np.int32)
    for b in range(nb):
        x[b, lens[b]:] = 0
    return x, lens


@pytest.mark.parametrize("B", [20011, 65536, 262144])
def test_tile_edges_match_plain(dev, B):
    """Both kernels on runs and literal gaps across tile edges, block_len
    ending mid-tile, and B % 16 != 0 (thread-copied tiles, byte stores)."""
    x, lens = _tile_spanning(B, 4, B)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    kw = dict(capacity=planar.capacity_for(B, 6), min_count=6)
    k = encode_sup.encode_blocks_kernel(xt, lt, **kw)
    pb = device.encode_blocks(xt, lt, **kw)
    for a, b in zip(k, (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds,
                        pb.n_lits)):
        assert torch.equal(a, b), B
    got = decode_sup.decode_columns_device(*k, lt, block_size=B)
    assert torch.equal(got, decode_sup.decode_columns_plain(*k, lt,
                                                            block_size=B))
    assert torch.equal(got, xt)


def test_one_block_of_4_mib(dev):
    """A 4 MiB block (a one-subsection Low Entropy stream's shape) spreads
    over the card in both kernels."""
    x = torch.from_numpy(_dct(4 << 20, 11)[None].copy()).to(dev)
    bl = torch.tensor([x.shape[1]], dtype=torch.int32, device=dev)
    kw = dict(capacity=planar.capacity_for(x.shape[1], 6), min_count=6)
    k = encode_sup.encode_blocks_kernel(x, bl, **kw)
    pb = device.encode_blocks(x, bl, **kw)
    for a, b in zip(k, (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds,
                        pb.n_lits)):
        assert torch.equal(a, b)
    assert torch.equal(decode_sup.decode_columns_device(
        *k, bl, block_size=x.shape[1]), x)


def test_encode_tight_capacity(dev):
    """At a capacity of exactly the commands the tail tile writes the
    column padding; one slot less raises."""
    x, lens, _, _ = _blocks("sparse", 65536, 4, 3)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    tight = int(device.encode_blocks(xt, lt, capacity=planar.capacity_for(
        65536, 6)).n_cmds.max())
    k = encode_sup.encode_blocks_kernel(xt, lt, capacity=tight)
    pb = device.encode_blocks(xt, lt, capacity=tight)
    for a, b in zip(k, (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds,
                        pb.n_lits)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        encode_sup.encode_blocks_kernel(xt, lt, capacity=tight - 1)


@pytest.mark.parametrize("codec", ["8 Bit", "8 Bit Single", "8 Bit Packed",
                                   "16 Bit (Symbol)", "24 Bit (Symbol)",
                                   "32 Bit (Symbol)", "128 Bit (Symbol)"])
def test_compress_kernel_matches_native(dev, codec):
    if native.lib() is None:
        pytest.skip("native runtime unavailable")
    raw = _dct(3 * 262144 + 1001, 4).tobytes()
    api.reset_kernel_launch_counts()
    blob = api.compress(raw, codec, backend="kernel", device=dev)
    assert api.kernel_launch_counts()["hrt1_encode"] == 1
    assert blob == api.compress(raw, codec, backend="native", device="cpu")
    assert api.decompress(blob, device=dev) == raw


# ---------------------------------------------------------------------------
# K4 (word_slice_sum, word_sampled_prefix), mmtf_scan, and the reference /
# Low Entropy streams decoded on the card
# ---------------------------------------------------------------------------

def _plane(shape, seed, dev, offset=0):
    """bf16 plane of integers in -4..4; ``offset`` elements into a larger
    buffer, so the data pointer can sit off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.integers(-4, 5, n + offset).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("shape,offset", [((4, 64, 128), 0),
                                          ((3, 20, 128), 0),
                                          ((5, 8, 128), 8),
                                          ((256, 2048, 128), 0)])
def test_word_kernels_match_plain(dev, shape, offset):
    x = _plane(shape, sum(shape), dev, offset)
    ss = micro_word.word_slice_sum(x)
    sp = micro_word.word_sampled_prefix(x)
    for name, fn in micro_word.PLAIN.items():
        want = fn(x)
        assert torch.equal(ss if "slice" in name else sp, want), name


@pytest.mark.parametrize("shape,offset,ok", [
    ((3, 12, 8), 0, True), ((7, 4, 64), 8, True), ((3, 12, 5), 0, False),
    ((1, 4, 1), 0, False), ((2, 8, 128), 1, False), ((7, 4, 64), 4, False)])
def test_word_slice_sum_odd_shapes(dev, shape, offset, ok):
    """Rows of whole 4-element groups on a 16-byte boundary launch the
    kernel; anything else is refused before a launch."""
    x = _plane(shape, 3, dev, offset)
    if not ok:
        with pytest.raises(ValueError):
            micro_word.word_slice_sum(x)
        return
    k = micro_word.word_slice_sum(x)
    assert torch.equal(k, micro_word.slice_sum_f32(x))
    assert torch.equal(k, micro_word.slice_sum_i32(x))


def test_word_kernels_count_launches(dev):
    x = _plane((2, 8, 128), 1, dev)
    api.reset_kernel_launch_counts()
    micro_word.word_slice_sum(x)
    micro_word.word_sampled_prefix(x)
    n = api.kernel_launch_counts()
    assert n["word_slice_sum"] == 1 and n["word_sampled_prefix"] == 1


def _mmtf_input(nb, units, lanes, seed, dev):
    """[nb, units * lanes] bytes, skewed in every third column; every byte
    value appears once the stream holds 256 bytes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (nb, units * lanes), dtype=np.uint8)
    x[:, ::3] %= 5
    flat = x.reshape(-1)
    flat[:min(256, flat.size)] = np.arange(min(256, flat.size))
    return torch.from_numpy(x).to(dev)


# (blocks, units) around the kernel's chunk length C: no units, one unit,
# fewer than C, C - 1 / C / C + 1, 2C - 1 / 2C / 2C + 1, many blocks
_C = mmtf_device.CHUNK
MMTF_SHAPES = [(2, 0), (1, 1), (3, 37), (1, _C - 1), (1, _C), (1, _C + 1),
               (2, 2 * _C - 1), (1, 2 * _C), (1, 2 * _C + 1), (8, 256)]


@pytest.mark.parametrize("shape", MMTF_SHAPES, ids=str)
@pytest.mark.parametrize("lanes", [1, 16, 32])
@pytest.mark.parametrize("encode", [True, False])
def test_mmtf_scan_matches_plain(dev, lanes, encode, shape):
    nb, units = shape
    x = _mmtf_input(nb, units, lanes, lanes + units, dev)
    k = mmtf_device.mmtf_scan(x, lanes=lanes, encode=encode)
    p = mmtf_device.mmtf_scan_plain(x, lanes=lanes, encode=encode)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("chunk", [1, 7, 256, mmtf_device.MAX_CHUNK])
def test_mmtf_scan_chunk_lengths(dev, chunk):
    """Every chunk length the kernel takes gives the plain version's
    outputs and tables, lanes 16, 32 and 40 (two lane groups)."""
    for lanes in (16, 32, 40):
        x = _mmtf_input(2, 1500, lanes, chunk, dev)
        for encode in (True, False):
            k = mmtf_device._launch(x, lanes, encode, chunk)
            p = mmtf_device.mmtf_scan_plain(x, lanes=lanes, encode=encode)
            torch.cuda.synchronize()
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_compress_on_every_card(dev):
    """Launch attributes are set per card (hrt1_encode's shared memory
    above 48 KiB, both kernels' grid sizes): one process compresses and
    decompresses the same data on every visible card in turn, and each
    blob equals the native bytes."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    if native.lib() is None:
        pytest.skip("native runtime unavailable")
    raw = _dct(3 * 262144 + 1001, 7).tobytes()
    want = api.compress(raw, "8 Bit", backend="native", device="cpu")
    for i in [*range(cards), 0]:
        card = torch.device("cuda", i)
        api.reset_kernel_launch_counts()
        assert api.compress(raw, "8 Bit", backend="kernel",
                            device=card) == want, card
        assert api.decompress(want, device=card) == raw, card
        n = api.kernel_launch_counts()
        assert n["hrt1_encode"] == 1 and n["hrt1_decode"] >= 1, (card, n)


def test_local_mesh_on_every_card(dev):
    """One process, every visible card (the LocalMesh of make_mesh() with
    no process group): compress_distributed equals the native bytes with
    hrt1_encode launched once a card, and pipeline_step returns the blocks
    on card 0 with exclusive-prefix offsets, hrt1_encode and hrt1_decode
    launched once a card.  Runs on one card too."""
    from hypersonic_rle_kit_tpu_torch.parallel import dist
    if native.lib() is None:
        pytest.skip("native runtime unavailable")
    cards = torch.cuda.device_count()
    mesh = dist.make_mesh()
    assert isinstance(mesh, dist.LocalMesh) and mesh.size == cards
    B = 1 << 16
    raw = _dct(7 * B + 1001, 8)
    want = api.compress(raw, "8 Bit", block_size=B, backend="native",
                        device="cpu")
    api.reset_kernel_launch_counts()
    assert dist.compress_distributed(raw, mesh, block_size=B) == want
    assert api.kernel_launch_counts()["hrt1_encode"] == cards
    x = _dct(2 * cards * B, 9).reshape(2 * cards, B)
    api.reset_kernel_launch_counts()
    y, offsets, sizes = dist.pipeline_step(
        x, np.full(2 * cards, B, np.int32),
        capacity=planar.capacity_for(B, 6), min_count=6, mesh=mesh)
    n = api.kernel_launch_counts()
    assert n["hrt1_encode"] == n["hrt1_decode"] == cards, n
    assert y.device == torch.device("cuda", 0)
    assert torch.equal(y.cpu(), torch.from_numpy(x))
    s = sizes.to(torch.int64)
    assert torch.equal(offsets, torch.cumsum(s, 0) - s)


# one NCCL rank of test_compress_distributed_nccl_on_every_card: argv
# WORKDIR WORLD RANK
_NCCL_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as tdist
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.parallel import dist
workdir, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.initialize_multihost(num_processes=world, process_id=rank,
                          backend="nccl", timeout=300,
                          store=tdist.FileStore(f"{workdir}/store", world))
data = np.fromfile(f"{workdir}/data.bin", np.uint8)
wire = []
all_gather = tdist.all_gather
def spy(out, t, *a, **k):
    wire.append(str(t.device))
    return all_gather(out, t, *a, **k)
tdist.all_gather = spy
api.reset_kernel_launch_counts()
blob = dist.compress_distributed(data, dist.make_mesh())
with open(f"{workdir}/rank{rank}.json", "w") as f:
    json.dump(dict(equal=blob == open(f"{workdir}/native.bin", "rb").read(),
                   card=torch.cuda.current_device(), wire=wire,
                   encodes=api.kernel_launch_counts()["hrt1_encode"]), f)
tdist.destroy_process_group()
"""


def test_compress_distributed_nccl_on_every_card(dev, tmp_path):
    """One NCCL rank per visible card, each a fresh interpreter, calls
    compress_distributed at its defaults (device "cuda", 64 KiB blocks):
    each rank computes and exchanges on its own card, and every rank's
    container equals the native bytes of 16 MiB of the DCT corpus."""
    from hypersonic_rle_kit_tpu_torch import datasets, graft_entry
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    if native.lib() is None:
        pytest.skip("native runtime unavailable")
    _kernels.lib()                  # built once, before the ranks load it
    raw = datasets.make_dataset(16)
    raw.tofile(tmp_path / "data.bin")
    (tmp_path / "native.bin").write_bytes(api.compress(
        raw, "8 Bit", block_size=1 << 16, backend="native", device="cpu"))
    graft_entry.run_ranks([sys.executable, "-c", _NCCL_RANK], cards,
                          tmp_path, timeout=300)
    for r in range(cards):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["equal"] and res["card"] == r, (r, res)
        assert res["wire"] and set(res["wire"]) == {f"cuda:{r}"}, (r, res)
        assert res["encodes"] >= 1, (r, res)


def test_mmtf_transform_on_card(dev):
    from hypersonic_rle_kit_tpu_torch.formats import mmtf as mmtf_host
    data = _dct(100_000 + 11, 5).tobytes()
    api.reset_kernel_launch_counts()
    for lanes in (16, 32):
        enc = mmtf_device.mmtf_transform(data, lanes=lanes, device=dev)
        assert enc == mmtf_host._mmtf(data, lanes, encode=True)
        assert mmtf_device.mmtf_transform(enc, lanes=lanes, encode=False,
                                          device=dev) == data
    assert api.kernel_launch_counts()["mmtf_scan"] == 4


@pytest.mark.parametrize("codec", ["8 Bit", "8 Bit Packed", "8 Bit Single",
                                   "8 Bit 3LUT Short", "16 Bit (Symbol)",
                                   "24 Bit (Symbol)", "64 Bit 3LUT (Symbol)",
                                   "128 Bit Packed (Byte)"])
def test_ref_stream_on_card(dev, codec):
    from hypersonic_rle_kit_tpu_torch.formats import registry
    raw = _dct(300_001, 6).tobytes()
    blob = registry.compress(raw, codec)
    api.reset_kernel_launch_counts()
    for bs in (ref_device.DEFAULT_BLOCK, 3001):
        assert ref_device.decompress_ref_device(blob, codec, block_size=bs,
                                                device=dev) == raw
    n = api.kernel_launch_counts()
    assert n == {**dict.fromkeys(n, 0), "hrt1_decode": 2}


def test_graft_entry_on_card_matches_cpu(dev):
    from hypersonic_rle_kit_tpu_torch import graft_entry
    fn, args = graft_entry.entry("cuda")
    cfn, cargs = graft_entry.entry("cpu")
    assert torch.equal(fn(*args).cpu(), cfn(*cargs))


def test_device_fuzz_lane_on_card(dev, tmp_path, monkeypatch):
    from hypersonic_rle_kit_tpu_torch import spec
    from hypersonic_rle_kit_tpu_torch import fuzz
    monkeypatch.chdir(tmp_path)
    api.reset_kernel_launch_counts()
    logs = []
    failures = fuzz.run_device(
        fuzz.random_inputs(6, 2),
        [spec.by_name(n) for n in fuzz.DEVICE_FUZZ_CODECS], log=logs.append,
        device=dev)
    torch.cuda.synchronize()
    assert failures == 0, logs
    assert api.kernel_launch_counts()["hrt1_decode"] > 0


@pytest.mark.parametrize("subs", [1, 3, 32])
def test_low_entropy_on_card(dev, subs):
    from hypersonic_rle_kit_tpu_torch.formats import low_entropy as le
    raw = _dct(200_003, subs).tobytes()
    api.reset_kernel_launch_counts()
    assert low_entropy_device.rle8m_decompress_device(
        le.rle8m_compress(subs, raw), device=dev) == raw
    assert low_entropy_device.le_decompress_device(
        le.le_compress(raw, short=subs == 3), device=dev) == raw
    assert api.kernel_launch_counts()["hrt1_decode"] == 2
