"""Port encode path and width transforms vs the JAX reference, on the CPU.

The same seeded numpy inputs go through the JAX function (the Pallas encode
kernel in interpret mode, as tests/test_encode_sup.py runs it) and through
the port's counterpart (on CPU tensors the hrt1_encode wrapper takes its
plain version).  Integers throughout, so the tolerance is zero: every
comparison is byte-exact, over whole tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypersonic_rle_kit_tpu import api as japi
from hypersonic_rle_kit_tpu.ops import decode_sup as jdecode
from hypersonic_rle_kit_tpu.ops import encode_sup as jencode
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.ops import decode_sup, encode_sup, planar

B = 2048
NAMES = ("sym", "count", "lit_len", "lits", "n_cmds", "n_lits")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(data, lens, min_count=6, only_sym=None):
    """Port vs the JAX kernel: all six outputs, whole tensors."""
    cap = planar.capacity_for(data.shape[1], min_count)
    want = jencode.encode_blocks_kernel(
        jnp.asarray(data), jnp.asarray(lens), capacity=cap,
        min_count=min_count, interpret=True,
        only_sym=None if only_sym is None else jnp.asarray(only_sym))
    got = encode_sup.encode_blocks_kernel(
        _t(data), _t(lens), capacity=cap, min_count=min_count,
        only_sym=None if only_sym is None else _t(only_sym))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    for b in range(data.shape[0]):      # and the host golden
        h = planar.host_encode_block(
            data[b, :lens[b]], cap, data.shape[1], min_count,
            None if only_sym is None or only_sym[b] < 0 else int(only_sym[b]))
        for name, g, r in zip(NAMES, got, h):
            np.testing.assert_array_equal(g[b].numpy(), r, name)


# ---------------------------------------------------------------------------
# (a) encode: the cases of tests/test_encode_sup.py, plus Single
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p_zero", [0.0, 0.5, 0.85, 0.99])
def test_encode_densities_match_jax(p_zero):
    rng = np.random.default_rng(int(p_zero * 100))
    data = rng.integers(-4, 5, (2, B)).astype(np.int8).astype(np.uint8)
    data[rng.random(data.shape) < p_zero] = 0
    lens = np.array([B, B - 77], np.int32)
    data[1, lens[1]:] = 0
    _check(data, lens)


@pytest.mark.parametrize("case", ["whole_run", "empty", "tiny", "tail_run",
                                  "adjacent", "min_count_edge"])
def test_encode_edges_match_jax(case):
    d = np.zeros((1, B), np.uint8)
    n = B
    if case == "whole_run":
        d[0, :] = 7
    elif case == "empty":
        n = 0
    elif case == "tiny":
        d[0, :5] = [9, 8, 7, 6, 5]
        n = 5
    elif case == "tail_run":
        n = B - 100
    elif case == "adjacent":
        d[0, :100] = 3
        d[0, 100:200] = 4
    elif case == "min_count_edge":
        d[0, 10:15] = 1     # 5 bytes: literal
        d[0, 20:26] = 2     # 6 bytes: run
    d[0, n:] = 0
    _check(d, np.array([n], np.int32))


def test_encode_min_count_parameter_matches_jax():
    d = np.zeros((1, B), np.uint8)
    d[0, 10:14] = 5  # 4-run: emitted at min_count 3, literal at min_count 6
    _check(d, np.array([B], np.int32), min_count=3)


def test_encode_only_sym_matches_jax():
    """Single: a long run of another byte becomes literals; a negative
    entry lifts the filter for its block."""
    rng = np.random.default_rng(8)
    data = rng.integers(-3, 4, (4, B)).astype(np.int8).astype(np.uint8)
    data[rng.random(data.shape) < 0.8] = 0
    data[:, 300:900] = 9
    lens = np.array([B, B, B - 500, 17], np.int32)
    for b in range(4):
        data[b, lens[b]:] = 0
    _check(data, lens, only_sym=np.array([0, 9, 3, -1], np.int32))


def test_encode_matches_plain_at_any_block_size():
    """Block sizes the TPU kernel refused (B % 128 != 0) encode like the
    golden; the plain version is the port's own XLA-encoder port."""
    rng = np.random.default_rng(3)
    for BB, mc in ((1000, 6), (4099, 1), (333, 4)):
        x = rng.integers(0, 3, (2, BB)).astype(np.uint8)
        lens = np.array([BB, BB // 2], np.int32)
        x[1, lens[1]:] = 0
        cap = planar.capacity_for(BB, mc)
        got = encode_sup.encode_blocks_kernel(_t(x), _t(lens), capacity=cap,
                                              min_count=mc)
        for b in range(2):
            h = planar.host_encode_block(x[b, :lens[b]], cap, BB, mc)
            for name, g, r in zip(NAMES, got, h):
                np.testing.assert_array_equal(g[b].numpy(), r, name)


def test_encode_rejects_bad_input():
    x = _t((np.arange(B) % 2).astype(np.uint8)[None])
    bl = _t(np.array([B], np.int32))
    with pytest.raises(ValueError, match="capacity"):
        encode_sup.encode_blocks_kernel(x, bl, capacity=256, min_count=1)
    with pytest.raises(ValueError, match="block_len"):
        encode_sup.encode_blocks_kernel(x, bl + 1, capacity=1024)
    with pytest.raises(TypeError):
        encode_sup.encode_blocks_kernel(x, bl.long(), capacity=1024)
    with pytest.raises(ValueError):
        encode_sup.encode_blocks_kernel(x[:, :0], bl, capacity=1024)
    with pytest.raises(ValueError):
        encode_sup.encode_blocks_kernel(x.to("meta"), bl.to("meta"),
                                        capacity=1024)


# ---------------------------------------------------------------------------
# (b) width transforms
# ---------------------------------------------------------------------------

WIDTHS = [2, 3, 4, 6, 8, 16]


def _lanes(w, nb=3):
    rng = np.random.default_rng(w)
    return rng.integers(0, 256, (nb, 96 * w), dtype=np.uint8)


@pytest.mark.parametrize("w", WIDTHS)
def test_interleave_plane_matches_jax(w):
    y = _lanes(w)
    nb, BB = y.shape
    want = np.asarray(japi._interleave_plane(jnp.asarray(y), nb=nb, w=w, B=BB))
    got = api._interleave_plane(_t(y), nb=nb, w=w, B=BB)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [4, 8, 16])
def test_interleave_words_matches_jax(w):
    yw = decode_sup.lits_to_words(_lanes(w))
    want = np.asarray(jdecode.interleave_words(jnp.asarray(yw), w=w))
    got = decode_sup.interleave_words(_t(yw), w=w)
    assert got.dtype == torch.int32 and got.shape == yw.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", WIDTHS)
def test_device_width_transforms_with_tail(w):
    """The device de-interleave equals the JAX package's host transform,
    tail block included, and the device re-interleave inverts it in both
    output forms."""
    rng = np.random.default_rng(10 + w)
    BB = 64 * w
    arr = rng.integers(0, 256, 2 * BB + 7 * w - 1, dtype=np.uint8)
    x, lens = japi._to_blocks(arr, BB)
    want, wlens = japi._deinterleave(x.copy(), lens, w)
    got = api._deinterleave(_t(x), lens, w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(api._lane_lens(lens, w), wlens)
    forms = [got]
    if w % 4 == 0:
        forms.append(got.view(torch.int32))
    for y in forms:
        back = api._interleave(y, lens, w)
        assert back.dtype == y.dtype and back.shape == y.shape
        flat = back.contiguous().view(torch.uint8).reshape(-1)
        np.testing.assert_array_equal(flat[:arr.size].numpy(), arr)


# ---------------------------------------------------------------------------
# (c) compress(backend="kernel") equals the JAX package's bytes
# ---------------------------------------------------------------------------

CODECS = ["8 Bit", "8 Bit Packed", "8 Bit Single", "24 Bit (Symbol)",
          "32 Bit (Symbol)"]


@pytest.mark.parametrize("codec", CODECS)
def test_compress_kernel_backend_matches_jax(codec):
    w = api.hrt1_params(api._resolve(codec))[0]
    rng = np.random.default_rng(12)
    raw = rng.integers(-9, 10, 2 * 16384 * w + 1001).astype(np.int8)
    raw = raw.astype(np.uint8)
    raw[rng.random(raw.size) < 0.75] = 0
    raw[5000:9000] = 7
    raw = raw.tobytes()
    kw = dict(block_size=16384 * w)
    blob = api.compress(raw, codec, backend="kernel", device="cpu", **kw)
    assert blob == japi.compress(raw, codec, backend="kernel", **kw)
    assert blob == japi.compress(raw, codec, backend="host", **kw)
    assert api.decompress(blob, device="cpu") == raw
