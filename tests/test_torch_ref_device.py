"""Reference-format streams decoded by the port (ops/ref_device.py), on the
CPU, vs the JAX package.

Streams come from the byte-exact host encoders; the port's
``decompress_ref_device`` (CPU tensors: hrt1_decode's plain version) must
equal the host decoders on the JAX test's 22 codecs x 5 datasets, and the
JAX package's ``decompress_ref_device`` (Pallas in interpret mode) on a
representative subset.  Byte-exact: the tolerance is zero.
"""

import numpy as np
import pytest

from hypersonic_rle_kit_tpu import spec as jspec
from hypersonic_rle_kit_tpu.formats import registry
from hypersonic_rle_kit_tpu.ops import ref_device as jref
from hypersonic_rle_kit_tpu_torch import spec
from hypersonic_rle_kit_tpu_torch.ops import ref_device
from hypersonic_rle_kit_tpu_torch.utils import native

CODECS = [
    "8 Bit", "8 Bit Packed", "8 Bit Single", "8 Bit Single Packed",
    "8 Bit 3LUT", "8 Bit 7LUT", "8 Bit Short", "8 Bit 3LUT Short",
    "8 Bit Single Short",
    "16 Bit (Symbol)", "16 Bit (Byte)", "16 Bit Packed (Symbol)",
    "24 Bit (Symbol)", "32 Bit (Byte)", "48 Bit Packed (Byte)",
    "64 Bit (Symbol)", "64 Bit 3LUT (Symbol)", "64 Bit 7LUT Short (Byte)",
    "128 Bit (Symbol)", "128 Bit Packed (Byte)",
    "32 Bit 1LUT Short (Symbol)", "16 Bit 3LUT (Byte)",
]


def _datasets():
    rng = np.random.default_rng(11)
    runs = np.repeat(rng.integers(0, 6, 700).astype(np.uint8),
                     rng.integers(1, 80, 700))
    mixed = rng.integers(0, 255, 40_000, dtype=np.uint8)
    mixed[rng.random(40_000) < 0.7] = 42
    periodic = np.tile(np.frombuffer(b"ABCDEFGH", np.uint8), 5_000).copy()
    periodic[rng.random(40_000) < 0.02] = 250
    tiny = np.frombuffer(b"xyzzyxyzzy", np.uint8)
    allsame = np.full(9_000, 7, np.uint8)
    return {"runs": runs, "mixed": mixed, "periodic": periodic,
            "tiny": tiny, "allsame": allsame}


DATA = _datasets()


def _blob(codec: str, ds: str) -> tuple[bytes, bytes]:
    data = DATA[ds].tobytes()
    blob = registry.compress(data, codec)
    if not blob:
        pytest.skip("encoder declined input")
    assert registry.decompress(blob, codec) == data
    return data, blob


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("ds", sorted(DATA))
def test_ref_stream_matches_host(codec, ds):
    data, blob = _blob(codec, ds)
    assert ref_device.decompress_ref_device(
        blob, codec, block_size=4096, device="cpu") == data


# packed grammars (MIN_RANGE 3: the JAX package's XLA fallback), widths
# 3 and 8 with a LUT, 16-byte symbols; one interpret-mode shape each
JAX_CASES = [("8 Bit Packed", "runs"), ("24 Bit (Symbol)", "periodic"),
             ("64 Bit 3LUT (Symbol)", "mixed"),
             ("128 Bit Packed (Byte)", "allsame")]


@pytest.mark.parametrize("codec,ds", JAX_CASES)
def test_ref_stream_matches_jax(codec, ds):
    data, blob = _blob(codec, ds)
    got = ref_device.decompress_ref_device(blob, codec, block_size=4096,
                                           device="cpu")
    assert got == jref.decompress_ref_device(blob, codec, block_size=4096,
                                             interpret=True)
    assert got == data


@pytest.mark.parametrize("codec,ds", [("8 Bit", "mixed"),
                                      ("24 Bit (Symbol)", "periodic"),
                                      ("8 Bit 3LUT Short", "runs")])
def test_walk_columns_match_jax(codec, ds):
    """The host walk (block-size rule included) gives the JAX package's
    columns, by the native walk and by the Python walkers."""
    _, blob = _blob(codec, ds)
    cspec = ref_device.codec_spec(codec)
    cols, usize, s, B = ref_device.walk(blob, cspec, 4096)
    m = -(-usize // s)
    assert B == min(4096, max(1024, -(-m // 1024) * 1024))
    it, _, _ = jref._iter_for(jspec.by_name(codec), blob)
    _, want = jref.parse_to_planar(blob, it, usize, s, B)
    for mine, theirs in zip(cols, want):
        np.testing.assert_array_equal(mine, theirs)


def test_python_walkers(monkeypatch):
    """With the native library off, the Python walkers feed the decoder."""
    monkeypatch.setattr(native, "lib", lambda: None)
    for codec, ds in [("8 Bit Packed", "runs"), ("16 Bit (Symbol)", "mixed"),
                      ("32 Bit 1LUT Short (Symbol)", "periodic")]:
        data, blob = _blob(codec, ds)
        assert ref_device.decompress_ref_device(
            blob, codec, block_size=2048, device="cpu") == data


def test_large_block_spanning_runs():
    """Runs and literal ranges crossing block boundaries split correctly."""
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(30):
        parts.append(np.full(rng.integers(1, 9000), rng.integers(0, 256),
                             np.uint8))
        parts.append(rng.integers(0, 256, rng.integers(1, 3000),
                     dtype=np.uint8))
    data = np.concatenate(parts).tobytes()
    blob = registry.compress(data, "8 Bit")
    got = ref_device.decompress_ref_device(blob, "8 Bit", block_size=2048,
                                           device="cpu")
    assert got == data
    # odd block sizes decode too (the TPU kernel wanted multiples of
    # 1024); the codec may also be given by spec or by registry index
    cspec = spec.by_name("8 Bit")
    for codec in (cspec, spec.REGISTRY.index(cspec)):
        assert ref_device.decompress_ref_device(
            blob, codec, block_size=3001, device="cpu") == data


def test_empty_stream():
    assert ref_device.decompress_ref_device(
        b"\x00" * 16, "16 Bit (Symbol)", device="cpu") == b""
