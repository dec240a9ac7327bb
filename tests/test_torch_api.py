"""Port api vs the JAX reference api, on the CPU.

``compress`` must produce the JAX package's bytes; ``decompress`` on the
CPU (the kernels' plain versions) must equal the JAX kernel path (Pallas in
interpret mode) and the input, for every container layout.  Byte-exact:
the tolerance is zero.
"""

import inspect
import itertools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hypersonic_rle_kit_tpu import api as japi
from hypersonic_rle_kit_tpu.ops import decode_sup as jdecode_sup
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.formats import low_entropy, registry
from hypersonic_rle_kit_tpu_torch.ops import (decode_sup, low_entropy_device,
                                              mmtf_device, planar, ref_device,
                                              unpack_device)
from hypersonic_rle_kit_tpu_torch.parallel import container, dist
from hypersonic_rle_kit_tpu_torch.utils import native

B = 4096


def _data(n: int, seed: int) -> bytes:
    """DCT-like bytes: short nonzero prefixes, zero runs, dense stretches."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-9, 10, n).astype(np.int8).astype(np.uint8)
    d[rng.random(n) < 0.75] = 0
    d[n // 3:n // 3 + 2000] = rng.integers(0, 256, 2000, dtype=np.uint8)
    d[n // 2:n // 2 + 3000] = 7
    return d.tobytes()


# ---------------------------------------------------------------------------
# (d) compress: the port's bytes are the JAX package's
# ---------------------------------------------------------------------------

CODECS = ["8 Bit", "8 Bit Packed", "8 Bit Single", "24 Bit (Symbol)",
          "32 Bit (Symbol)"]


@pytest.mark.parametrize("backend", ["native", "host"])
@pytest.mark.parametrize("codec", CODECS)
def test_compress_bytes_match_jax(codec, backend):
    if backend == "native" and native.lib() is None:
        pytest.skip("native runtime unavailable")
    raw = _data(50_001, 1)
    blob = api.compress(raw, codec, backend=backend, device="cpu")
    assert blob == japi.compress(raw, codec, backend=backend)
    assert api.decompress(blob, device="cpu") == raw


@pytest.mark.parametrize("codec", ["8 Bit", "8 Bit Single",
                                   "32 Bit (Symbol)"])
def test_compress_device_backend_matches_host(codec):
    raw = _data(20_011, 2)
    blob = api.compress(raw, codec, block_size=B * 4, backend="device",
                        device="cpu")
    assert blob == japi.compress(raw, codec, block_size=B * 4,
                                 backend="host")


def test_compress_kernel_backend_runs():
    """backend="kernel" on the CPU runs the hrt1_encode wrapper's plain
    version and launches no kernel."""
    raw = _data(20_011, 7)
    api.reset_kernel_launch_counts()
    blob = api.compress(raw, "8 Bit", block_size=B, backend="kernel",
                        device="cpu")
    assert api.kernel_launch_counts()["hrt1_encode"] == 0
    assert blob == japi.compress(raw, "8 Bit", block_size=B, backend="host")
    assert api.decompress(blob, device="cpu") == raw
    with pytest.raises(ValueError):
        api.compress(raw, backend="pallas")


@pytest.mark.parametrize("have_native", [True, False])
def test_compress_auto_backend_rule(monkeypatch, have_native):
    """auto on an explicit device="cpu": native if the library builds, else
    the plain device encoder; the bytes are the same either way."""
    seen = []
    real = api._encode_on_device

    def spy(*a, kernel, **k):
        seen.append(kernel)
        return real(*a, kernel=kernel, **k)

    monkeypatch.setattr(api, "_encode_on_device", spy)
    if not have_native:
        monkeypatch.setattr(api.native, "lib", lambda: None)
    elif native.lib() is None:
        pytest.skip("native runtime unavailable")
    raw = _data(9_001, 8)
    blob = api.compress(raw, "8 Bit", block_size=B, device="cpu")
    assert seen == ([] if have_native else [False])
    assert blob == japi.compress(raw, "8 Bit", block_size=B, backend="host")
    if have_native:
        assert blob == api.compress(raw, "8 Bit", block_size=B,
                                    backend="native", device="cpu")


def test_compress_defaults_to_the_card(monkeypatch):
    """compress runs on the card unless asked for the CPU: the default
    device is "cuda", and auto picks the hrt1_encode kernel there, native
    library or not."""
    assert inspect.signature(api.compress).parameters["device"].default \
        == "cuda"

    class Picked(Exception):
        pass

    def spy(x, lens, w, cap, min_count, only_sym, dev, *, kernel):
        raise Picked(dev.type, kernel)

    monkeypatch.setattr(api, "_encode_on_device", spy)
    with pytest.raises(Picked) as e:
        api.compress(_data(9_001, 9), "8 Bit", block_size=B)
    assert e.value.args == ("cuda", True)


# each device entry point and an input it takes (None: it needs a mesh)
_ENTRY_POINTS = {
    "api.decompress": (api.decompress,
                       lambda raw: (api.compress(raw, device="cpu"),)),
    "decompress_ref_device": (ref_device.decompress_ref_device,
                              lambda raw: (registry.compress(raw, "8 Bit"),
                                           "8 Bit")),
    "le_decompress_device": (low_entropy_device.le_decompress_device,
                             lambda raw: (low_entropy.le_compress(raw),)),
    "rle8m_decompress_device": (low_entropy_device.rle8m_decompress_device,
                                lambda raw: (low_entropy.rle8m_compress(
                                    4, raw),)),
    "mmtf_transform": (mmtf_device.mmtf_transform, lambda raw: (raw,)),
    "compress_distributed": (dist.compress_distributed, None),
}


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_device_entry_points_default_to_the_card(name):
    """Every device entry point runs on the card unless the caller asks
    for the CPU: ``device`` defaults to "cuda", and without a card a call
    at that default raises instead of falling back to the CPU."""
    fn, make_args = _ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if make_args is None:
        return
    raw = _data(9_001, 10)
    args = make_args(raw)
    if name != "mmtf_transform":
        assert fn(*args, device="cpu") == raw
    if torch.cuda.is_available():
        assert fn(*args) == fn(*args, device="cpu")
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args)


def test_jax_api_names():
    """The JAX package's small public names: no kernel fallback is ever
    taken, the reference walk's parse_to_planar, the mesh's block axis."""
    from hypersonic_rle_kit_tpu.ops import ref_device as jref_device
    from hypersonic_rle_kit_tpu_torch.ops import ref_walk
    assert api.kernel_fallback_count() == japi.kernel_fallback_count() == 0
    assert ref_device.parse_to_planar is ref_walk.parse_to_planar
    assert inspect.signature(ref_device.parse_to_planar) == inspect.signature(
        jref_device.parse_to_planar)
    assert dist.BLOCK_AXIS == "blocks"
    assert dist.make_mesh(devices=["cpu"]).axis == dist.BLOCK_AXIS


def test_compress_bounds_and_empty():
    assert api.compress_bounds(10 ** 6) == japi.compress_bounds(10 ** 6)
    blob = api.compress(b"", device="cpu")
    assert blob == japi.compress(b"")
    assert api.decompress(blob, device="cpu") == b""


# ---------------------------------------------------------------------------
# (e) decompress: port == JAX kernel path == input, every layout
# ---------------------------------------------------------------------------

def _cols(raw: bytes, min_count: int = 6):
    x, lens = api._to_blocks(np.frombuffer(raw, np.uint8), B)
    cap = planar.capacity_for(B, min_count)
    outs = [planar.host_encode_block(x[b, :lens[b]], cap, B, min_count)
            for b in range(x.shape[0])]
    return ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])


def _layouts():
    """The same data in each HRT1 layout (flat, deep, deep + literal
    dictionary, non-uniform widths)."""
    raw = _data(3 * B - 123, 3)
    cols = _cols(raw)
    nb = cols[0].shape[0]
    blobs = {"flat": container.serialize_blocks(0, len(raw), B, 6, *cols,
                                                deep=False),
             "nonuniform": container.serialize_blocks(
                 0, len(raw), B, 6, *cols, deep=False, uniform_bits=False)}
    sym, count, lit_len, lits, n_cmds, n_lits = cols
    pooled_c = np.concatenate([count[b, :n_cmds[b] - 1].astype(np.int64) - 6
                               for b in range(nb)])
    pooled_l = np.concatenate([lit_len[b, :n_cmds[b]].astype(np.int64)
                               for b in range(nb)])
    widths = (container._two_tier_widths(pooled_c)
              + container._two_tier_widths(pooled_l))
    for name, lit_k, flags in (
            ("deep", 0, container.FLAG_DEEP),
            ("deep_litdict", 4, container.FLAG_DEEP | container.FLAG_LITDICT)):
        parts = [container.block_payload_deep(
            sym[b], count[b], lit_len[b], lits[b], int(n_cmds[b]),
            int(n_lits[b]), 6, widths, lit_k=lit_k) for b in range(nb)]
        blobs[name] = container.assemble(0, len(raw), B, parts, flags=flags)
    return raw, blobs


LAYOUTS = ["flat", "deep", "deep_litdict", "nonuniform"]


@pytest.fixture(scope="module")
def layouts():
    return _layouts()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decompress_matches_jax_kernel_path(layouts, layout):
    raw, blobs = layouts
    blob = blobs[layout]
    info, _ = container.parse(blob)
    assert info.deep == layout.startswith("deep")
    assert info.litdict == (layout == "deep_litdict")
    assert (container.pack_for_device(blob) is None) == (layout ==
                                                          "nonuniform")
    got = api.decompress(blob, device="cpu")
    assert got == raw
    assert japi.decompress(blob, backend="kernel") == got


@pytest.mark.parametrize("codec", ["24 Bit (Symbol)", "32 Bit (Symbol)",
                                   "16 Bit (Symbol)"])
def test_decompress_widths_with_tail_block(codec):
    """Width codecs decode in byte lanes and re-interleave on the device,
    including a partial tail block."""
    w = api.hrt1_params(api._resolve(codec))[0]
    raw = _data(5 * B * w // 2 + 7 * w - 1, 4)
    blob = api.compress(raw, codec, block_size=B * w, device="cpu")
    assert blob == japi.compress(raw, codec, block_size=B * w)
    assert api.decompress(blob, device="cpu") == raw
    assert japi.decompress(blob, backend="device") == raw


def test_decompress_rejects_bad_width():
    blob = bytearray(api.compress(_data(9000, 5), "8 Bit", block_size=4097,
                                  device="cpu"))
    blob[4] = japi._resolve("32 Bit (Symbol)").index     # w=4, 4097 % 4 != 0
    with pytest.raises(container.ContainerError):
        api.decompress(bytes(blob), device="cpu")


def test_decompress_rejects_unknown_device():
    blob = api.compress(_data(9000, 6), "8 Bit", block_size=B, device="cpu")
    with pytest.raises(ValueError):
        api.decompress(blob, device="meta")


# ---------------------------------------------------------------------------
# the JAX package's other decoders: decompress(backend='device' | 'host') and
# decode_sup.decode_planar_sup, on a seeded DCT input and golden records
# ---------------------------------------------------------------------------

def _gap_input(name: str) -> bytes:
    """The seeded DCT-like bytes, or the first records of a committed
    golden pack (reference-codec outputs, real bytes), cut to ~20 KB."""
    if name == "dct":
        return _data(5 * B - 333, 12)
    import ref_oracle
    recs = ref_oracle._load_pack(int(name.removeprefix("golden")))
    return b"".join(itertools.islice(recs.values(), 4))[:5 * B - 333]


GAP_INPUTS = ["dct", "golden000", "golden040"]


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("codec", ["8 Bit", "24 Bit (Symbol)",
                                   "32 Bit (Symbol)"])
@pytest.mark.parametrize("name", GAP_INPUTS)
def test_decompress_backends_match_jax(name, codec, backend):
    """Each backend gives the JAX package's bytes under the same backend,
    which are the kernel path's and the input."""
    raw = _gap_input(name)
    w = api.hrt1_params(api._resolve(codec))[0]
    blob = api.compress(raw, codec, block_size=B * w, device="cpu")
    got = api.decompress(blob, backend=backend, device="cpu")
    assert got == japi.decompress(blob, backend=backend) == raw
    assert api.decompress(blob, backend="kernel", device="cpu") == got


def test_decompress_rejects_unknown_backend():
    blob = api.compress(_data(9000, 7), "8 Bit", block_size=B, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        japi.decompress(blob, backend="xla")
    with pytest.raises(ValueError, match="unknown backend"):
        api.decompress(blob, backend="xla", device="cpu")


@pytest.mark.parametrize("name", GAP_INPUTS)
def test_decode_planar_sup_matches_jax(name):
    """Host columns in, decoded blocks out: the JAX kernel (interpret
    mode) and the port's wrapper (its plain version on the CPU)."""
    raw = _gap_input(name)
    _, lens = api._to_blocks(np.frombuffer(raw, np.uint8), B)
    cols = _cols(raw)
    got = decode_sup.decode_planar_sup(*cols, lens, block_size=B,
                                       device="cpu")
    want = jdecode_sup.decode_planar_sup(*cols, lens, block_size=B,
                                         interpret=True)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().reshape(-1)[:len(raw)].tobytes() == raw


def test_decode_entry_points_default_to_the_card():
    for fn in (decode_sup.decode_planar_sup, decode_sup.decode_host_columns):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(api.decompress).parameters[
        "backend"].default == "auto"


@pytest.mark.parametrize("codec", ["8 Bit", "16 Bit (Symbol)",
                                   "8 Bit Packed"])
def test_fuzz_corpus_roundtrip_matches_jax(codec):
    """The repo's fuzz corpus (random and repeated-symbol sections, tiny
    and odd lengths) through both packages at a small block size."""
    import fuzz_inputs
    for raw in fuzz_inputs.corpus(count=6):
        blob = api.compress(raw, codec, block_size=B, device="cpu")
        assert blob == japi.compress(raw, codec, block_size=B)
        assert api.decompress(blob, device="cpu") == raw


# ---------------------------------------------------------------------------
# (f) a hostile deep container raises ContainerError
# ---------------------------------------------------------------------------

def test_hostile_deep_container_raises():
    """Construction of tests/test_container_harden.py: zero a block's lut
    section so the miss population exceeds the stored n_miss."""
    rng = np.random.default_rng(11)
    data = np.zeros(300_000, np.uint8)
    pos = k = 0
    while pos < data.size - 400:
        run = int(rng.integers(8, 60))
        data[pos:pos + run] = k % 251
        k += 1
        pos += run + int(rng.integers(0, 6))
    blob = api.compress(data.tobytes(), device="cpu")
    info, blocks = container.parse(blob)
    assert info.deep
    bl = blocks[0]
    offs, sizes = container._deep_sections(bl, bl["n_cmds"], bl["n_lits"])
    buf = bytearray(blob)
    p = bl["payload_off"] + offs[4]
    buf[p:p + sizes[4]] = bytes(sizes[4])
    hostile = bytes(buf)
    container.parse(hostile)          # still structurally valid
    pk = container.pack_for_device(hostile)
    _, bad = unpack_device.dispatch_packed(
        pk, unpack_device.ship_packed(pk, "cpu"), with_flags=True)
    assert int(bad[0]) == 1 and not bad[1:].any()
    with pytest.raises(container.ContainerError):
        unpack_device.decode_packed(pk, device="cpu")
    with pytest.raises(container.ContainerError):
        api.decompress(hostile, device="cpu")


# ---------------------------------------------------------------------------
# (g) the port imports nothing of the JAX package
# ---------------------------------------------------------------------------

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """A fresh interpreter imports every port module, chip_smoke.py and the
    port's scripts; afterwards neither the JAX package nor jax is loaded,
    and CUDA is not initialised."""
    port = _ROOT / "hypersonic_rle_kit_tpu_torch"
    mods = sorted(".".join(f.relative_to(_ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for f in port.rglob("*.py"))
    scripts = [f.stem for f in sorted((_ROOT / "scripts").glob("*_torch*.py"))]
    code = "\n".join(
        ["import importlib, sys", "sys.path.insert(0, 'scripts')"]
        + [f"importlib.import_module({m!r})" for m in mods + ["chip_smoke"]
           + scripts]
        + ["bad = sorted(m for m in sys.modules if m in ('jax', 'bench',"
           " 'hypersonic_rle_kit_tpu') or m.startswith(('jax.',"
           " 'hypersonic_rle_kit_tpu.')))",
           "assert not bad, bad",
           "assert not sys.modules['torch'].cuda.is_initialized()"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
