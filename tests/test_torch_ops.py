"""Port ops vs the JAX reference, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the JAX package's own tests run them) and through the
torch port's counterpart (its plain versions: CPU tensors never reach a
CUDA kernel).  Integers throughout, so the tolerance is zero: every
comparison is byte-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypersonic_rle_kit_tpu.ops import decode_sup as jdecode
from hypersonic_rle_kit_tpu.ops import device as jdevice
from hypersonic_rle_kit_tpu.ops import planar as jplanar
from hypersonic_rle_kit_tpu.ops import unpack_device as junpack
from hypersonic_rle_kit_tpu.parallel import container
from hypersonic_rle_kit_tpu_torch.ops import decode_sup, device, planar
from hypersonic_rle_kit_tpu_torch.ops import unpack_device

B = 4096
NB = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) bit-unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [0, 1, 7, 13, 25])
def test_unpack_wide_matches_jax(width):
    rng = np.random.default_rng(width)
    n = 256
    S = (max((width * n + 7) // 8, 1) + 4 + 127) // 128 * 128
    packed = np.zeros((NB, S), np.uint8)
    vals = rng.integers(0, 1 << max(width, 1), (NB, n)) if width else \
        np.zeros((NB, n), np.int64)
    for b in range(NB):
        raw = container._bitpack(vals[b], width)
        packed[b, :len(raw)] = np.frombuffer(raw, np.uint8)
    want = np.asarray(junpack._unpack_wide(jnp.asarray(packed), width, n))
    got = unpack_device._unpack_wide(_t(packed), width, n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals)


# ---------------------------------------------------------------------------
# (b) decode kernel's plain version vs the Pallas kernel and XLA decode
# ---------------------------------------------------------------------------

def _encoded(kind: str):
    """[NB, B] blocks of one edge case -> (planar columns, block lens)."""
    rng = np.random.default_rng(len(kind))
    lens = np.full(NB, B, np.int32)
    x = rng.integers(-4, 5, (NB, B)).astype(np.int8).astype(np.uint8)
    if kind.startswith("p_zero"):
        x[rng.random(x.shape) < float(kind[6:])] = 0
    elif kind == "all_literal":
        x = rng.integers(0, 256, (NB, B), dtype=np.uint8)
    elif kind == "all_run":
        x[:] = rng.integers(0, 256, (NB, 1), dtype=np.uint8)
    elif kind == "ragged_tail":
        x[rng.random(x.shape) < 0.9] = 0
        lens[:] = [B, B - 777, 17]
    elif kind == "dense_min_runs":
        x = np.repeat(rng.integers(0, 251, (NB, B // 6 + 1)), 6,
                      axis=1)[:, :B].astype(np.uint8)
    for b in range(NB):
        x[b, lens[b]:] = 0
    cap = planar.capacity_for(B, 6)
    outs = [planar.host_encode_block(x[b, :lens[b]], cap, B, 6)
            for b in range(NB)]
    cols = ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])
    return cols, lens, x


def _zero_count_mid():
    """count == 0 commands mid-stream (tests/test_decode_sup.py), padded to
    the shared capacity so every case shares one compiled JAX kernel."""
    cap = planar.capacity_for(B, 6)
    sym = np.zeros((NB, cap), np.uint8)
    count = np.zeros((NB, cap), np.int32)
    lit_len = np.zeros((NB, cap), np.int32)
    lits = np.zeros((NB, B), np.uint8)
    lits[:, :12] = np.arange(1, 13)
    sym[:, 0] = 65
    count[:, 0] = 10
    lit_len[:, :3] = [4, 3, 5]
    n_cmds = np.full(NB, 3, np.int32)
    n_lits = np.full(NB, 12, np.int32)
    lens = np.full(NB, 22, np.int32)
    want = np.zeros((NB, B), np.uint8)
    want[:, :4] = [1, 2, 3, 4]
    want[:, 4:14] = 65
    want[:, 14:17] = [5, 6, 7]
    want[:, 17:22] = [8, 9, 10, 11, 12]
    return [sym, count, lit_len, lits, n_cmds, n_lits], lens, want


DECODE_CASES = ["p_zero0.0", "p_zero0.5", "p_zero0.99", "all_literal",
                "all_run", "ragged_tail", "dense_min_runs", "zero_count_mid"]


def _case(kind):
    if kind == "zero_count_mid":
        return _zero_count_mid()
    return _encoded(kind)


@pytest.mark.parametrize("kind", DECODE_CASES)
def test_decode_plain_matches_jax(kind):
    cols, lens, want = _case(kind)
    litw = decode_sup.lits_to_words(cols[3])
    args = [cols[0], cols[1], cols[2], litw, cols[4], cols[5], lens]
    # the JAX kernel's words contract, in interpret mode
    jw = np.asarray(jdecode.decode_columns_device(
        *[jnp.asarray(a) for a in args], block_size=B, interpret=True,
        out_words=True))
    pw = decode_sup.decode_columns_device(*[_t(a) for a in args],
                                          block_size=B, out_words=True)
    assert pw.dtype == torch.int32 and pw.shape == (NB, B // 4)
    np.testing.assert_array_equal(pw.numpy(), jw)
    # bytes form, and the XLA decoder the kernel's plain version ports
    pb = decode_sup.decode_columns_device(*[_t(a) for a in args],
                                          block_size=B)
    xla = np.asarray(jdevice.decode_blocks(jplanar.PlanarBlocks(
        *[jnp.asarray(a) for a in cols], jnp.asarray(lens))))
    np.testing.assert_array_equal(pb.numpy(), xla)
    np.testing.assert_array_equal(pb.numpy(), want)
    np.testing.assert_array_equal(decode_sup.words_to_bytes(jw), want)


def test_decode_plain_bytes_form_matches_jax_kernel():
    cols, lens, want = _encoded("p_zero0.5")
    args = [cols[0], cols[1], cols[2], cols[3], cols[4], cols[5], lens]
    jb = np.asarray(jdecode.decode_columns_device(
        *[jnp.asarray(a) for a in args], block_size=B, interpret=True))
    pb = decode_sup.decode_columns_device(*[_t(a) for a in args],
                                          block_size=B)
    assert pb.dtype == torch.uint8
    np.testing.assert_array_equal(pb.numpy(), jb)
    np.testing.assert_array_equal(pb.numpy(), want)


def test_decode_any_block_size_and_trimmed_literals():
    """Block sizes the TPU kernel refused (not a multiple of 1024, odd) and
    a literal section narrower than the block decode like the golden."""
    for BB in (1000, 4099):
        rng = np.random.default_rng(BB)
        x = rng.integers(0, 3, (2, BB)).astype(np.uint8)
        cap = planar.capacity_for(BB, 4)
        outs = [planar.host_encode_block(x[b], cap, BB, 4) for b in range(2)]
        cols = ([np.stack([o[i] for o in outs]) for i in range(4)]
                + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])
        lw = -(-int(cols[5].max()) // 128) * 128
        cols[3] = np.ascontiguousarray(cols[3][:, :lw])
        y = decode_sup.decode_columns_device(
            *[_t(a) for a in cols], _t(np.full(2, BB, np.int32)),
            block_size=BB)
        np.testing.assert_array_equal(y.numpy(), x)


def test_decode_rejects_bad_input():
    cols, lens, _ = _encoded("p_zero0.5")
    t = [_t(a) for a in cols] + [_t(lens)]
    with pytest.raises(TypeError):
        decode_sup.decode_columns_device(t[0], t[1].long(), *t[2:],
                                         block_size=B)
    with pytest.raises(ValueError):
        decode_sup.decode_columns_device(*t, block_size=B + 2,
                                         out_words=True)
    with pytest.raises(ValueError):
        decode_sup.decode_columns_device(t[0][:, :5], *t[1:], block_size=B)


# ---------------------------------------------------------------------------
# plain torch encode / decode vs XLA and the host golden
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["p_zero0.5", "all_literal", "all_run",
                                  "ragged_tail", "dense_min_runs"])
@pytest.mark.parametrize("single", [False, True])
def test_encode_blocks_matches_jax(kind, single):
    _, lens, x = _encoded(kind)
    cap = planar.capacity_for(B, 6)
    osym = np.array([0, 3, 255], np.int32) if single else None
    jp = jdevice.encode_blocks(jnp.asarray(x), jnp.asarray(lens),
                               capacity=cap, min_count=6,
                               only_sym=None if osym is None
                               else jnp.asarray(osym))
    tp = device.encode_blocks(_t(x), _t(lens), capacity=cap, min_count=6,
                              only_sym=None if osym is None else _t(osym))
    for name in ("sym", "count", "lit_len", "n_cmds", "n_lits", "block_len"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    for b in range(NB):
        nl = int(tp.n_lits[b])
        np.testing.assert_array_equal(tp.lits[b, :nl].numpy(),
                                      np.asarray(jp.lits)[b, :nl])
        h = planar.host_encode_block(
            x[b, :lens[b]], cap, B, 6, None if osym is None else int(osym[b]))
        np.testing.assert_array_equal(tp.count[b].numpy(), h[1])
    np.testing.assert_array_equal(device.decode_blocks(tp).numpy(), x)


# ---------------------------------------------------------------------------
# (c) resolver's plain version vs the Pallas resolver; shipping
# ---------------------------------------------------------------------------

def _runs_blob(seed: int, long_frac: float) -> bytes:
    """A deep container: many distinct run symbols (dictionary hits and
    misses), short runs and literal stretches, and a ``long_frac`` share of
    long ones, which escape to the overflow lists."""
    rng = np.random.default_rng(seed)
    data = np.zeros(3 * B, np.uint8)
    pos = k = 0
    while pos < data.size:
        long_run, long_lit = rng.random(2) < long_frac
        run = int(rng.integers(300, 600) if long_run else rng.integers(6, 9))
        data[pos:pos + run] = (k * 7) % 23
        k += 1
        lit = int(rng.integers(100, 200) if long_lit else rng.integers(0, 3))
        data[pos + run:pos + run + lit] = rng.integers(100, 140, lit)
        pos += run + lit
    x, lens = data.reshape(3, B), np.full(3, B, np.int32)
    cap = planar.capacity_for(B, 6)
    outs = [planar.host_encode_block(x[b], cap, B, 6) for b in range(3)]
    cols = ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])
    return container.serialize_blocks(0, data.size, B, 6, *cols, deep=True)


@pytest.mark.parametrize("escapes", [True, False])
def test_resolve_plain_matches_jax(escapes):
    blob = _runs_blob(3, 0.05 if escapes else 0.0)
    pk = container.pack_for_device(blob)
    assert pk is not None and pk["info"].deep
    assert pk["cnt_bits"] and pk["lit_bits"]
    assert (int(pk["n_cnt_ovf"].sum()) > 0) == escapes
    if escapes:
        assert int(pk["n_ll_ovf"].sum()) > 0
    cap = pk["capacity"]
    keys = (("cnts_raw", "cnt_bits"), ("cnt_ovf_raw", "cnt_ovf_bits"),
            ("lls_raw", "lit_bits"), ("ll_ovf_raw", "ll_ovf_bits"))
    kw = dict(cap=cap, cnt_bits=pk["cnt_bits"] if pk["cnt_ovf_bits"] else 0,
              lit_bits=pk["lit_bits"] if pk["ll_ovf_bits"] else 0,
              min_count=pk["info"].min_count)
    jplanes = [junpack._unpack_wide(jnp.asarray(pk[k]), pk[w], cap)
               for k, w in keys]
    jlut = junpack._unpack_wide(jnp.asarray(pk["lut_raw"]), 3, cap)
    want = junpack._resolve_deep(
        *jplanes, jlut, jnp.asarray(pk["miss_raw"]).astype(jnp.int32),
        jnp.asarray(pk["dict7"]), jnp.asarray(pk["n_cmds"]), interpret=True,
        **kw)
    a = unpack_device.ship_packed(pk, "cpu")
    tplanes = [unpack_device._unpack_wide(a[k], pk[w], cap) for k, w in keys]
    got = unpack_device.resolve_deep_plain(
        *tplanes, unpack_device._unpack_wide(a["lut_raw"], 3, cap),
        a["miss_raw"], a["dict7"], a["n_cmds"], **kw)
    assert got[2].dtype == torch.uint8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int32),
                                      np.asarray(w))


def test_ship_buffers_match_jax():
    blob = _runs_blob(5, 0.05)
    pk = container.pack_for_device(blob)
    ju8, ji32, jman = junpack.build_ship_buffers(pk)
    tu8, ti32, tman = unpack_device.build_ship_buffers(pk)
    assert tman == jman
    np.testing.assert_array_equal(tu8, ju8)
    np.testing.assert_array_equal(ti32, ji32)
    arrs = unpack_device.ship_packed(pk, "cpu")
    for k in unpack_device.SECTION_KEYS:
        if k in pk:
            np.testing.assert_array_equal(arrs[k].numpy(), pk[k], k)


def test_decode_packed_matches_jax():
    blob = _runs_blob(6, 0.03)
    pk = container.pack_for_device(blob)
    want = junpack.decode_packed(pk, interpret=True)
    got = unpack_device.decode_packed(pk, device="cpu")
    np.testing.assert_array_equal(got, want)
