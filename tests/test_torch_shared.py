"""The port keeps its own copies of the host modules it shares with the JAX
package, and imports nothing of that package.

- No ``import`` of ``hypersonic_rle_kit_tpu`` or ``bench``, at any depth,
  in the port, in ``chip_smoke.py`` or in ``scripts/*_torch*.py`` (an ast
  scan; ``tests/test_torch_api.py::test_port_imports_no_jax`` imports them
  all in a fresh interpreter).
- Each copy gives its original's bytes, on the CPU: the 121 codecs of
  ``formats``, the ``spec`` tables, the HRT1 container (serialize, parse,
  pack_for_device on flat, deep and deep + litdict containers), the native
  host runtime, the grammar walkers, the fuzz inputs, the host fuzz lane,
  the bit-packing goldens and the benchmark corpora.  Tolerance zero.
"""

import ast
import dataclasses
import itertools
import pathlib

import numpy as np
import pytest

import bench
import ref_oracle
from hypersonic_rle_kit_tpu import fuzz as jfuzz
from hypersonic_rle_kit_tpu import spec as jspec
from hypersonic_rle_kit_tpu.formats import registry as jregistry
from hypersonic_rle_kit_tpu.ops import bitpack as jbitpack
from hypersonic_rle_kit_tpu.ops import ref_device as jref
from hypersonic_rle_kit_tpu.parallel import container as jcontainer
from hypersonic_rle_kit_tpu.utils import native as jnative
from hypersonic_rle_kit_tpu_torch import datasets, fuzz, spec
from hypersonic_rle_kit_tpu_torch.formats import registry
from hypersonic_rle_kit_tpu_torch.ops import bitpack, planar, ref_walk
from hypersonic_rle_kit_tpu_torch.parallel import container
from hypersonic_rle_kit_tpu_torch.utils import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "hypersonic_rle_kit_tpu_torch"


def _port_files() -> list[pathlib.Path]:
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*_torch*.py")))


def _forbidden(name: str) -> bool:
    return (name in ("hypersonic_rle_kit_tpu", "bench")
            or name.startswith(("hypersonic_rle_kit_tpu.", "bench.")))


def test_port_sources_import_no_jax_package():
    """ast scan: every import statement, top-level or nested in a function,
    of every port module, chip_smoke.py and scripts/*_torch*.py."""
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert len(_port_files()) > 30
    assert not bad, bad


# ---------------------------------------------------------------------------
# the copies against their originals
# ---------------------------------------------------------------------------

def _input(seed: int = 17) -> bytes:
    """4 KiB + 13 B: runs of several lengths, literals, a long run."""
    rng = np.random.default_rng(seed)
    n = 4096 + 13
    d = rng.integers(0, 256, n, dtype=np.uint8)
    d[rng.random(n) < 0.6] = 0
    d[1000:1400] = 7
    d[2048:2100] = np.tile(np.array([1, 2, 3], np.uint8), 18)[:52]
    return d.tobytes()


@pytest.mark.parametrize("index", range(jspec.CODEC_COUNT))
def test_codec_bytes_equal_original(index):
    name = jspec.REGISTRY[index].name
    raw = _input()
    blob = registry.compress(raw, name)
    assert blob == jregistry.compress(raw, name)
    assert registry.decompress(blob, name) == raw
    assert jregistry.decompress(blob, name) == raw


def test_spec_tables_equal_original():
    assert spec.CODEC_COUNT == jspec.CODEC_COUNT == len(spec.REGISTRY)
    assert [(f.name, f.value) for f in spec.Family] == \
        [(f.name, f.value) for f in jspec.Family]

    def row(s):
        return {k: (v.name if hasattr(v, "name") and not isinstance(v, str)
                    else v) for k, v in dataclasses.asdict(s).items()}
    assert [row(s) for s in spec.REGISTRY] == [row(s) for s in jspec.REGISTRY]
    for s in jspec.REGISTRY:
        assert spec.by_name(s.name).index == s.index
        assert spec.by_index(s.index).name == s.name


def _columns(raw: bytes, B: int, min_count: int = 6):
    x = np.zeros(-(-len(raw) // B) * B, np.uint8)
    x[:len(raw)] = np.frombuffer(raw, np.uint8)
    x = x.reshape(-1, B)
    lens = np.full(x.shape[0], B, np.int32)
    lens[-1] = len(raw) - (x.shape[0] - 1) * B
    return x, lens, planar.capacity_for(B, min_count)


def _container_input(name: str) -> bytes:
    """Raw streams for containers: the DCT corpus and the first records of
    a few committed golden packs (reference-codec outputs, real bytes)."""
    if name == "dct":
        return datasets.make_dataset(1)[:300_001].tobytes()
    recs = ref_oracle._load_pack(int(name.removeprefix("golden")))
    return b"".join(itertools.islice(recs.values(), 3))


@pytest.mark.parametrize("name", ["dct", "golden000", "golden007",
                                  "golden040"])
def test_container_equal_original(name):
    raw = _container_input(name)
    B = 1 << 16
    x, lens, cap = _columns(raw, B)
    cols = native.planar_from_bytes(x, lens, cap, 6)
    jcols = jnative.planar_from_bytes(x, lens, cap, 6)
    assert all(np.array_equal(a, b) for a, b in zip(cols, jcols))
    nb = x.shape[0]
    blobs = {"flat": dict(deep=False), "auto": {}}
    for key, kw in blobs.items():
        blob = container.serialize_blocks(0, len(raw), B, 6, *cols, **kw)
        assert blob == jcontainer.serialize_blocks(0, len(raw), B, 6, *cols,
                                                   **kw)
        blobs[key] = blob
    sym, count, lit_len, lits, n_cmds, n_lits = cols
    pooled_c = np.concatenate([count[b, :n_cmds[b] - 1].astype(np.int64) - 6
                               for b in range(nb)])
    pooled_l = np.concatenate([lit_len[b, :n_cmds[b]].astype(np.int64)
                               for b in range(nb)])
    widths = (container._two_tier_widths(pooled_c)
              + container._two_tier_widths(pooled_l))
    assert widths == (jcontainer._two_tier_widths(pooled_c)
                      + jcontainer._two_tier_widths(pooled_l))
    for key, lit_k, flags in (
            ("deep", 0, container.FLAG_DEEP),
            ("deep_litdict", 4, container.FLAG_DEEP | container.FLAG_LITDICT)):
        parts = [container.block_payload_deep(
            sym[b], count[b], lit_len[b], lits[b], int(n_cmds[b]),
            int(n_lits[b]), 6, widths, lit_k=lit_k) for b in range(nb)]
        blobs[key] = container.assemble(0, len(raw), B, parts, flags=flags)
        assert blobs[key] == jcontainer.assemble(
            0, len(raw), B, [jcontainer.block_payload_deep(
                sym[b], count[b], lit_len[b], lits[b], int(n_cmds[b]),
                int(n_lits[b]), 6, widths, lit_k=lit_k) for b in range(nb)],
            flags=flags)
    for key, blob in blobs.items():
        info, blocks = container.parse(blob)
        jinfo, jblocks = jcontainer.parse(blob)
        assert dataclasses.asdict(info) == dataclasses.asdict(jinfo), key
        assert blocks == jblocks, key
        pk, jpk = container.pack_for_device(blob), \
            jcontainer.pack_for_device(blob)
        assert (pk is None) == (jpk is None), key
        if pk is not None:
            assert pk.keys() == jpk.keys()
            for k in pk:
                if k == "info":
                    assert dataclasses.asdict(pk[k]) == \
                        dataclasses.asdict(jpk[k])
                elif isinstance(pk[k], np.ndarray):
                    assert np.array_equal(pk[k], jpk[k]), (key, k)
                else:
                    assert pk[k] == jpk[k], (key, k)
        got = container.deserialize_to_planar(blob)[1]
        want = jcontainer.deserialize_to_planar(blob)[1]
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), key


def test_native_equal_original():
    if native.lib() is None or jnative.lib() is None:
        pytest.skip("native runtime unavailable")
    assert native._SO != jnative._SO
    raw = datasets.make_dataset(1)[:200_003].tobytes()
    x, lens, cap = _columns(raw, 1 << 14, 4)
    only = np.resize(np.array([0, 9, -1], np.int32), x.shape[0])
    for kw in ({}, {"only_sym": only}):
        got = native.planar_from_bytes(x, lens, cap, 4, **kw)
        want = jnative.planar_from_bytes(x, lens, cap, 4, **kw)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for name in ("8 Bit", "24 Bit (Symbol)", "64 Bit 3LUT (Symbol)",
                 "32 Bit 1LUT Short (Symbol)", "128 Bit Packed (Byte)"):
        s = spec.by_name(name)
        blob = registry.compress(raw, name)
        fam, fl = ref_walk._native_args(s)
        usize = len(raw)
        got = native.ref_parse_planar(blob, fam, s.width or 8, fl, s.lut or 0,
                                      usize, 1 << 15)
        want = jnative.ref_parse_planar(blob, fam, s.width or 8, fl,
                                        s.lut or 0, usize, 1 << 15)
        assert got is not None and want is not None
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
        assert got[1:] == want[1:]


@pytest.mark.parametrize("name", ["8 Bit Packed", "16 Bit (Symbol)",
                                  "128 Bit (Byte)", "16 Bit 3LUT (Symbol)",
                                  "24 Bit Short (Byte)"])
def test_ref_walk_equal_original(name):
    """The Python grammar walkers, one codec per family."""
    s, js = spec.by_name(name), jspec.by_name(name)
    raw = _input(5) * 3
    blob = registry.compress(raw, name)
    it, usize, w = ref_walk._iter_for(s, blob)
    jit, jusize, jw = jref._iter_for(js, blob)
    assert (usize, w) == (jusize, jw)
    assert (usize, w) == (len(raw), max(1, (s.width or 8) // 8))
    assert ref_walk._native_args(s) == jref._native_args(js)
    got = ref_walk.parse_to_planar(blob, it, usize, w, 1024)[1]
    want = jref.parse_to_planar(blob, jit, jusize, jw, 1024)[1]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_fuzz_inputs_and_corpora_equal_original():
    assert fuzz.BOUNDARY_LENGTHS == jfuzz.BOUNDARY_LENGTHS
    assert fuzz.DEVICE_FUZZ_CODECS == jfuzz.DEVICE_FUZZ_CODECS
    assert list(fuzz.random_inputs(6, 5)) == list(jfuzz.random_inputs(6, 5))
    assert (list(itertools.islice(fuzz.iterative_inputs(4), 12))
            == list(itertools.islice(jfuzz.iterative_inputs(4), 12)))
    for make in ("make_dataset", "make_bwt_dataset", "make_sh_dataset",
                 "make_random_dataset"):
        assert np.array_equal(getattr(datasets, make)(1),
                              getattr(bench, make)(1)), make


@pytest.mark.parametrize("width", range(1, 9))
def test_bitpack_numpy_goldens_equal_original(width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, 1 << width, (3, 64), dtype=np.uint8)
    packed = bitpack.pack_np(x, width)
    assert np.array_equal(packed, jbitpack.pack_np(x, width))
    got = bitpack.unpack_np(packed, width, 64)
    assert np.array_equal(got, jbitpack.unpack_np(packed, width, 64))
    assert np.array_equal(got, x)


# the host fuzz lane: one or two codecs of every family but memcpy
HOST_FUZZ_CODECS = ["8 Bit Packed", "8 Bit Single",
                    "16 Bit 1LUT Short (Symbol)",
                    "32 Bit 3LUT Short Grdy (Byte)", "16 Bit 3LUT (Symbol)",
                    "24 Bit Packed (Symbol)", "128 Bit (Byte)",
                    "8 Bit RLE + Huffman-esque", "8 Bit MMTF 128",
                    "Low Entropy Single", "Low Entropy Short",
                    "Multi MTF 128 Bit (Transform)",
                    "Bit MMTF 16 Bit (Transform)"]


def test_host_fuzz_codecs_span_every_family():
    assert ({spec.by_name(n).family for n in HOST_FUZZ_CODECS}
            == set(spec.Family) - {spec.Family.MEMCPY})


@pytest.mark.parametrize("name", HOST_FUZZ_CODECS)
def test_host_fuzz_lane_equal_original(name):
    """fuzz_one on the same seeded inputs: both clean."""
    for data in fuzz.random_inputs(4, 2):
        got = fuzz.fuzz_one(data, spec.by_name(name))
        assert got == jfuzz.fuzz_one(data, jspec.by_name(name))
        assert got is None


def _planted(kind: str, reg):
    """A codec of ``reg`` that fails the host lane in one way."""
    compress, decompress = reg.compress, reg.decompress

    def writes_input(data, s):
        out = compress(bytes(data), s)
        data[len(data) // 2] ^= 1
        return out

    def wrong_bytes(buf, s):
        out = decompress(buf, s)
        return out[:-1] + bytes([out[-1] ^ 1])

    return {"writes_input": ("compress", writes_input),
            "empty": ("compress", lambda data, s: b""),
            "wrong_bytes": ("decompress", wrong_bytes)}[kind]


@pytest.mark.parametrize("kind", ["writes_input", "empty", "wrong_bytes"])
def test_host_fuzz_lane_reports_like_original(kind, tmp_path, monkeypatch):
    """A codec that writes into its input, returns nothing or decodes the
    wrong bytes: both lanes give the same error string, and ``run`` logs
    the same failure and saves the same input."""
    for reg in (registry, jregistry):
        monkeypatch.setattr(reg, *_planted(kind, reg))
    monkeypatch.chdir(tmp_path)
    data = next(fuzz.random_inputs(4, 1))
    got = fuzz.fuzz_one(bytearray(data), spec.by_name("8 Bit"))
    assert got is not None
    assert got == jfuzz.fuzz_one(bytearray(data), jspec.by_name("8 Bit"))
    saved = []
    for mod, sp in ((fuzz, spec), (jfuzz, jspec)):
        logs = []
        assert mod.run([bytearray(data)], [sp.by_name("8 Bit")],
                       log=logs.append) == 1
        saved.append((logs, (tmp_path / "fuzz-failure.bin").read_bytes()))
    assert saved[0] == saved[1]
    assert got in saved[0][0][0]


@pytest.mark.parametrize("argv", [[], ["--skip-slow"],
                                  ["--codec", "8 Bit", "--codec", "memcpy",
                                   "--codec", "Low Entropy"]])
def test_host_fuzz_main_picks_the_original_codecs(argv, monkeypatch):
    """Without --device, main fuzzes the codecs the JAX package's main
    does (every one but memcpy; --skip-slow drops MMTF and greedy)."""
    picked = []
    for mod in (fuzz, jfuzz):
        monkeypatch.setattr(mod, "run", lambda inputs, specs: picked.append(
            [s.name for s in specs]) or 0)
        assert mod.main(argv + ["--iterations", "0"]) == 0
    assert picked[0] == picked[1] and picked[0]
