"""The column-prep stage (bit-unpack, escape resolution, ``bad`` flags) of
the port vs the JAX reference, on the CPU.

``unpack_resolve_plain`` -- the plain version of the hrt1_unpack_resolve
kernel, which CPU tensors take -- against the JAX package's own functions
(``_unpack_wide``, the Pallas resolver ``_resolve_deep`` in interpret mode,
and ``decode_deep_device``'s ``bad`` flags through ``dispatch_packed``),
on real containers and on random sections at the widths and capacities
the kernel must take.  Integers throughout: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypersonic_rle_kit_tpu.ops import planar
from hypersonic_rle_kit_tpu.ops import unpack_device as junpack
from hypersonic_rle_kit_tpu.parallel import container
from hypersonic_rle_kit_tpu_torch.ops import unpack_device

B = 4096
MIN_COUNT = 6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _serialize(data: np.ndarray, deep: bool) -> bytes:
    x = data.reshape(-1, B)
    cap = planar.capacity_for(B, MIN_COUNT)
    outs = [planar.host_encode_block(r, cap, B, MIN_COUNT) for r in x]
    cols = ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])
    return container.serialize_blocks(0, data.size, B, MIN_COUNT, *cols,
                                      deep=deep)


def _runs(seed: int, long_frac: float) -> np.ndarray:
    """Many distinct run symbols (dictionary hits and misses), short runs
    and literal stretches, and a ``long_frac`` share of long ones, which
    escape to the overflow lists; the deep layout without a literal
    dictionary."""
    rng = np.random.default_rng(seed)
    data = np.zeros(3 * B, np.uint8)
    pos = k = 0
    while pos < data.size:
        long_run, long_lit = rng.random(2) < long_frac
        run = int(rng.integers(300, 600) if long_run else rng.integers(6, 9))
        data[pos:pos + run] = (k * 7) % 23
        k += 1
        lit = int(rng.integers(100, 200) if long_lit else rng.integers(0, 3))
        # literals of every byte value but the run symbols' (0..22): no
        # literal dictionary pays, and no literal lengthens a run
        seg = data[pos + run:pos + run + lit]
        seg[:] = rng.integers(23, 256, lit)[:seg.size]
        pos += run + lit
    return data


def _dct(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(-3, 4, 3 * B).astype(np.int8).astype(np.uint8)
    d[rng.random(d.size) < 0.8] = 0
    return d


def _pack(kind: str) -> dict:
    """pack_for_device of one container kind."""
    if kind == "flat":
        pk = container.pack_for_device(_serialize(_runs(4, 0.05), False))
        assert not pk["info"].deep
        return pk
    data = {"deep_escapes": _runs(3, 0.05), "deep_no_escapes": _runs(3, 0.0),
            "deep_litdict": _dct(2), "deep_tampered": _runs(7, 0.05)}[kind]
    pk = container.pack_for_device(_serialize(data, True))
    assert pk["info"].deep
    assert pk["info"].litdict == (kind == "deep_litdict")
    assert (int(pk["n_cnt_ovf"].sum()) > 0) == (kind != "deep_no_escapes")
    if kind == "deep_tampered":
        # stored sub-header populations that disagree with the escapes of
        # blocks 0 and 2; block 1 keeps its own
        pk["n_cnt_ovf"][0] += 1
        pk["n_ll_ovf"][2] -= 1
        pk["n_miss"][2] += 3
    return pk


def _jax_columns(pk: dict):
    """The JAX package's count / lit_len (/ sym) of a pack, its own
    functions: _unpack_wide, then the Pallas resolver in interpret mode
    (deep) or decode_payload_device's where()s (flat)."""
    cap = pk["capacity"]
    nc = jnp.asarray(pk["n_cmds"])[:, None]
    cnt = junpack._unpack_wide(jnp.asarray(pk["cnts_raw"]), pk["cnt_bits"],
                               cap)
    ll = junpack._unpack_wide(jnp.asarray(pk["lls_raw"]), pk["lit_bits"], cap)
    if not pk["info"].deep:
        idx = jnp.arange(cap, dtype=jnp.int32)[None, :]
        return (jnp.where(idx < nc - 1, cnt + pk["info"].min_count, 0),
                jnp.where(idx < nc, ll, 0))
    return junpack._resolve_deep(
        cnt, junpack._unpack_wide(jnp.asarray(pk["cnt_ovf_raw"]),
                                  pk["cnt_ovf_bits"], cap),
        ll, junpack._unpack_wide(jnp.asarray(pk["ll_ovf_raw"]),
                                 pk["ll_ovf_bits"], cap),
        junpack._unpack_wide(jnp.asarray(pk["lut_raw"]), 3, cap),
        jnp.asarray(pk["miss_raw"]).astype(jnp.int32),
        jnp.asarray(pk["dict7"]), jnp.asarray(pk["n_cmds"]), cap=cap,
        cnt_bits=pk["cnt_bits"] if pk["cnt_ovf_bits"] else 0,
        lit_bits=pk["lit_bits"] if pk["ll_ovf_bits"] else 0,
        min_count=pk["info"].min_count, interpret=True)


CONTAINERS = ["deep_escapes", "deep_no_escapes", "deep_litdict", "flat",
              "deep_tampered"]


@pytest.mark.parametrize("kind", CONTAINERS)
def test_unpack_resolve_plain_matches_jax(kind):
    pk = _pack(kind)
    arrs = unpack_device.ship_packed(pk, "cpu")
    args, kw = unpack_device.section_args(pk, arrs)
    got = unpack_device.unpack_resolve_plain(*args, **kw)
    # the wrapper takes the plain version on CPU tensors
    for a, b in zip(got, unpack_device.unpack_resolve(*args, **kw)):
        assert (a is None and b is None) or torch.equal(a, b)
    want = _jax_columns(pk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int32),
                                      np.asarray(w))
    assert got[0].dtype == got[1].dtype == torch.int32
    # bad through the JAX package's whole decode (decode_deep_device)
    jarrs = {k: jnp.asarray(pk[k]) for k in junpack.SECTION_KEYS if k in pk}
    jw, jbad = junpack.dispatch_packed(pk, jarrs, interpret=True,
                                       with_flags=True, out_words=True)
    if pk["info"].deep:
        assert got[2].dtype == torch.uint8 and got[3].dtype == torch.int32
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(jbad))
        assert got[3].tolist() == ([1, 0, 1] if kind == "deep_tampered"
                                   else [0, 0, 0])
    else:
        assert got[2] is None and got[3] is None and jbad is None
    # and the port's dispatch on the same sections, flags included
    out, bad = unpack_device.dispatch_packed(pk, arrs, with_flags=True,
                                             out_words=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jw))
    if bad is None:
        assert jbad is None
    else:
        np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))


@pytest.mark.parametrize("out_words", [False, True])
@pytest.mark.parametrize("kind", CONTAINERS)
def test_section_decoders_match_jax(kind, out_words):
    """decode_payload_device (flat) / decode_deep_device (deep) with the
    JAX package's argument lists, the port's on its shipped CPU sections
    against the JAX functions in interpret mode on the same sections:
    equal output and equal bad flags (set on the tampered blocks)."""
    pk = _pack(kind)
    arrs = unpack_device.ship_packed(pk, "cpu")
    jarrs = {k: jnp.asarray(pk[k]) for k in junpack.SECTION_KEYS if k in pk}
    info = pk["info"]
    kw = dict(cnt_bits=pk["cnt_bits"], lit_bits=pk["lit_bits"],
              capacity=pk["capacity"], block_size=info.block_size,
              min_count=info.min_count, out_words=out_words)
    if info.deep:
        keys = ("cnts_raw", "cnt_ovf_raw", "lls_raw", "ll_ovf_raw",
                "lut_raw", "miss_raw", "dict7", "lits", "n_cmds", "n_lits",
                "block_len", "n_cnt_ovf", "n_ll_ovf", "n_miss")
        kw.update(cnt_ovf_bits=pk["cnt_ovf_bits"],
                  ll_ovf_bits=pk["ll_ovf_bits"])
        out, bad = unpack_device.decode_deep_device(
            *(arrs[k] for k in keys), **kw)
        jout, jbad = junpack.decode_deep_device(
            *(jarrs[k] for k in keys), **kw, interpret=True)
        np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
        assert bad.tolist() == ([1, 0, 1] if kind == "deep_tampered"
                                else [0, 0, 0])
    else:
        keys = ("cnts_raw", "lls_raw", "syms", "lits", "n_cmds", "n_lits",
                "block_len")
        out = unpack_device.decode_payload_device(
            *(arrs[k] for k in keys), **kw)
        jout = junpack.decode_payload_device(
            *(jarrs[k] for k in keys), **kw, interpret=True)
        bad = None
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert out.dtype == (torch.int32 if out_words else torch.uint8)
    dout, dbad = unpack_device.dispatch_packed(pk, arrs, with_flags=True,
                                               out_words=out_words)
    assert torch.equal(dout, out)
    assert (dbad is None and bad is None) or torch.equal(dbad, bad)


def test_ship_and_decode_packed_default_to_the_card():
    """ship_packed(pk) and decode_packed(pk), the JAX package's calls, run
    on the card by default: here, with no card, they raise torch's error
    (no CPU fallback); on the CPU they decode the container."""
    import inspect
    pk = _pack("deep_escapes")
    for fn in (unpack_device.ship_packed, unpack_device.decode_packed):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    want = junpack.decode_packed(pk, interpret=True)
    np.testing.assert_array_equal(
        unpack_device.decode_packed(pk, device="cpu"), want)
    if torch.cuda.is_available():
        np.testing.assert_array_equal(unpack_device.decode_packed(pk), want)
        return
    with pytest.raises((RuntimeError, AssertionError)):
        unpack_device.ship_packed(pk)
    with pytest.raises((RuntimeError, AssertionError)):
        unpack_device.decode_packed(pk)


# ---------------------------------------------------------------------------
# random sections: every width the kernel takes, hostile n_cmds
# ---------------------------------------------------------------------------

# (cnt_bits, lit_bits, cnt_ovf_bits, ll_ovf_bits): each of 0, 1, 7, 8, 25
# in every role
WIDTHS = [(0, 1, 7, 8), (1, 7, 8, 25), (7, 8, 25, 0), (8, 25, 0, 1),
          (25, 0, 1, 7)]
CAPS = [8, 43776]


def _random_sections(widths, cap: int, seed: int) -> dict:
    """Random packed bytes of each width, a miss row and dictionary, and
    n_cmds -1, 0, 1, mid, cap, 2 cap; at a width of 1 or 7 most values are
    escapes."""
    rng = np.random.default_rng(seed)
    nb = 6

    def sec(w):
        S = ((w * cap + 7) // 8 + 4 + 127) // 128 * 128
        return rng.integers(0, 256, (nb, S), dtype=np.uint8)

    cb, lb, cob, lob = widths
    return dict(cnts_raw=sec(cb), lls_raw=sec(lb), cnt_ovf_raw=sec(cob),
                ll_ovf_raw=sec(lob), lut_raw=sec(3),
                miss_raw=rng.integers(0, 256, (nb, cap), dtype=np.uint8),
                dict7=rng.integers(0, 256, (nb, 7), dtype=np.uint8),
                n_cmds=np.array([-1, 0, 1, cap // 2 + 3, cap, 2 * cap],
                                np.int32))


def _jax_random(s: dict, widths, cap: int):
    """The JAX package's functions on random sections: _unpack_wide, the
    Pallas resolver (interpret mode; a capacity under its 128-lane rows is
    zero-padded, which changes no rank of the entries kept) and
    decode_deep_device's flag sums (unpack_device.py:247-261).  Returns
    (count, lit_len, sym, escape populations)."""
    cb, lb, cob, lob = widths
    capj = max(cap, 128)

    def unpack(k, w):
        v = junpack._unpack_wide(jnp.asarray(s[k]), w, cap)
        return jnp.pad(v, ((0, 0), (0, capj - cap)))

    cnt, ll, lut = unpack("cnts_raw", cb), unpack("lls_raw", lb), \
        unpack("lut_raw", 3)
    nc = jnp.asarray(s["n_cmds"])
    cols = junpack._resolve_deep(
        cnt, unpack("cnt_ovf_raw", cob), ll, unpack("ll_ovf_raw", lob), lut,
        jnp.pad(jnp.asarray(s["miss_raw"]).astype(jnp.int32),
                ((0, 0), (0, capj - cap))),
        jnp.asarray(s["dict7"]), nc, cap=capj, cnt_bits=cb if cob else 0,
        lit_bits=lb if lob else 0, min_count=MIN_COUNT, interpret=True)
    idx = jnp.arange(cap, dtype=jnp.int32)[None, :]
    is_run, is_cmd = idx < nc[:, None] - 1, idx < nc[:, None]
    cnt, ll, lut = cnt[:, :cap], ll[:, :cap], lut[:, :cap]
    pops = (jnp.sum((is_run & (cnt == (1 << cb) - 1)).astype(jnp.int32), 1)
            if cb else None,
            jnp.sum((is_cmd & (ll == (1 << lb) - 1)).astype(jnp.int32), 1)
            if lb else None,
            jnp.sum((is_run & (lut == 0)).astype(jnp.int32), 1))
    return [np.asarray(c)[:, :cap] for c in cols], pops


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_unpack_resolve_random_sections_match_jax(widths, cap):
    s = _random_sections(widths, cap, seed=sum(widths) + cap)
    (jcount, jlit, jsym), pops = _jax_random(s, widths, cap)
    # stored populations: the true one on even blocks, one off on odd
    want_bad = np.zeros(6, np.int32)
    for name, pop in zip(("n_cnt_ovf", "n_ll_ovf", "n_miss"), pops):
        true = np.asarray(pop) if pop is not None else np.zeros(6, np.int32)
        s[name] = (true + np.arange(6) % 2).astype(np.int32)
        want_bad |= (np.arange(6) % 2).astype(np.int32)
    t = {k: _t(v) for k, v in s.items()}
    cb, lb, cob, lob = widths
    kw = dict(cnt_bits=cb, lit_bits=lb, cnt_ovf_bits=cob, ll_ovf_bits=lob,
              capacity=cap, min_count=MIN_COUNT)
    count, lit_len, sym, bad = unpack_device.unpack_resolve_plain(
        t.pop("cnts_raw"), t.pop("lls_raw"), t.pop("n_cmds"), **t, **kw)
    np.testing.assert_array_equal(count.numpy(), jcount)
    np.testing.assert_array_equal(lit_len.numpy(), jlit)
    np.testing.assert_array_equal(sym.numpy().astype(np.int32), jsym)
    np.testing.assert_array_equal(bad.numpy(), want_bad)
    # the flat layout on the same count / lit_len sections
    idx = np.arange(cap)[None, :]
    nc = s["n_cmds"][:, None].astype(np.int64)
    fc, fl, fs, fb = unpack_device.unpack_resolve_plain(
        _t(s["cnts_raw"]), _t(s["lls_raw"]), _t(s["n_cmds"]), cnt_bits=cb,
        lit_bits=lb, capacity=cap, min_count=MIN_COUNT)
    jc = np.asarray(junpack._unpack_wide(jnp.asarray(s["cnts_raw"]), cb, cap))
    jl = np.asarray(junpack._unpack_wide(jnp.asarray(s["lls_raw"]), lb, cap))
    np.testing.assert_array_equal(fc.numpy(),
                                  np.where(idx < nc - 1, jc + MIN_COUNT, 0))
    np.testing.assert_array_equal(fl.numpy(), np.where(idx < nc, jl, 0))
    assert fs is None and fb is None


def test_unpack_resolve_rejects_bad_input():
    s = {k: _t(v) for k, v in _random_sections((6, 4, 8, 8), 128, 0).items()}
    kw = dict(cnt_bits=6, lit_bits=4, capacity=128, min_count=MIN_COUNT)
    args = (s["cnts_raw"], s["lls_raw"], s["n_cmds"])
    unpack_device.unpack_resolve(*args, **kw)
    for bad_kw, match in ((dict(cnt_bits=26), "width <= 25"),
                          (dict(capacity=124), "n % 8"),
                          (dict(lit_bits=20), "too short")):
        with pytest.raises(ValueError, match=match):
            unpack_device.unpack_resolve(*args, **{**kw, **bad_kw})
    with pytest.raises(ValueError, match="n_cmds"):
        unpack_device.unpack_resolve(*args[:2], args[2].long(), **kw)
    with pytest.raises(ValueError, match="miss_raw"):
        unpack_device.unpack_resolve(
            *args, s["cnt_ovf_raw"], s["ll_ovf_raw"], s["lut_raw"],
            s["miss_raw"][:, :64].contiguous(), s["dict7"], **kw)
    with pytest.raises(ValueError, match="lls_raw"):
        unpack_device.unpack_resolve(s["cnts_raw"], s["lls_raw"][:, ::2],
                                     s["n_cmds"], **kw)
