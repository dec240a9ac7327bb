"""The port's bitpack, MMTF / Bit-MMTF and Low Entropy / rle8m device paths
vs the JAX package, on the CPU.

Mirrors tests/test_device_transforms.py: the same seeded numpy inputs go
through the JAX function and its counterpart in the port (CPU tensors:
the kernels' plain versions), and the outputs must be equal byte for byte
(tolerance 0: integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypersonic_rle_kit_tpu.formats import low_entropy as le
from hypersonic_rle_kit_tpu.formats import mmtf as mmtf_host
from hypersonic_rle_kit_tpu.ops import bitpack as jbitpack
from hypersonic_rle_kit_tpu.ops import low_entropy_device as jled
from hypersonic_rle_kit_tpu.ops import mmtf_device as jmd
from hypersonic_rle_kit_tpu_torch.ops import bitpack, low_entropy_device as led
from hypersonic_rle_kit_tpu_torch.ops import mmtf_device as md


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("width", [1, 2, 3, 4, 8])
def test_bitpack_matches_jax(width):
    rng = np.random.default_rng(width)
    n = 24 * 16                      # multiple of 8 for every width
    x = rng.integers(0, 1 << width, (3, n), dtype=np.uint8)
    packed = bitpack.pack_device(_t(x), width=width).numpy()
    assert packed.shape == (3, bitpack.packed_size(n, width))
    np.testing.assert_array_equal(
        packed, np.asarray(jbitpack.pack_device(jnp.asarray(x), width=width)))
    np.testing.assert_array_equal(packed, jbitpack.pack_np(x, width))
    # unpack a prefix of the values too (n_values < what the bytes hold)
    for nv in (n, n - 5):
        un = bitpack.unpack_device(_t(packed), width=width, n_values=nv)
        np.testing.assert_array_equal(un.numpy(), x[:, :nv])
        np.testing.assert_array_equal(
            un.numpy(), np.asarray(jbitpack.unpack_device(
                jnp.asarray(packed), width=width, n_values=nv)))


def test_bitpack_sizes_and_bad_input():
    assert bitpack.packed_size(128, 4) == 64
    assert bitpack.packed_size(128, 1) == 16
    assert bitpack.packed_size(5, 3) == 2
    x = torch.zeros((2, 12), dtype=torch.uint8)
    with pytest.raises(ValueError):
        bitpack.pack_device(x, width=3)          # 36 bits: not whole bytes
    with pytest.raises(ValueError):
        bitpack.pack_device(x, width=9)
    with pytest.raises(ValueError):
        bitpack.unpack_device(x, width=4, n_values=25)


@pytest.mark.parametrize("lanes", [16, 32])
def test_mmtf_device_matches_jax_and_host(lanes):
    rng = np.random.default_rng(lanes)
    n = lanes * 37
    data = rng.integers(0, 7, n, dtype=np.uint8)
    x = data[None]
    enc = md.mmtf_device(_t(x), lanes=lanes, encode=True).numpy()
    np.testing.assert_array_equal(
        enc, np.asarray(jmd.mmtf_device(jnp.asarray(x), lanes=lanes,
                                        encode=True)))
    assert enc[0].tobytes() == mmtf_host._mmtf(data.tobytes(), lanes,
                                               encode=True)
    dec = md.mmtf_device(_t(enc), lanes=lanes, encode=False).numpy()
    np.testing.assert_array_equal(dec, x)
    wrap = md.mmtf128_device if lanes == 16 else md.mmtf256_device
    assert torch.equal(wrap(_t(x)), _t(enc))


@pytest.mark.parametrize("encode", [True, False])
def test_mmtf_scan_final_table_matches_jax(encode):
    rng = np.random.default_rng(5)
    units = rng.integers(0, 256, (24, 16), dtype=np.uint8)
    out, table = md.mmtf_scan(_t(units.reshape(1, -1)), lanes=16,
                              encode=encode)
    jt, jout = jmd._mtf_scan(jnp.asarray(units), lanes=16, encode=encode)
    np.testing.assert_array_equal(out.numpy().reshape(24, 16),
                                  np.asarray(jout))
    np.testing.assert_array_equal(table.numpy()[0], np.asarray(jt))
    assert table.dtype == torch.int32


def test_mmtf_device_block_parallel():
    """Blocks are independent chains: batched == per-block == JAX."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (4, 16 * 8), dtype=np.uint8)
    batched = md.mmtf_device(_t(x), lanes=16).numpy()
    np.testing.assert_array_equal(
        batched, np.asarray(jmd.mmtf_device(jnp.asarray(x), lanes=16)))
    for b in range(4):
        single = md.mmtf_device(_t(x[b:b + 1]), lanes=16).numpy()
        np.testing.assert_array_equal(batched[b], single[0])


@pytest.mark.parametrize("lanes,n", [(16, 16 * 5 + 11), (32, 32 * 3 + 31),
                                     (16, 7)])
def test_mmtf_transform_partial_tail(lanes, n):
    """Any length, incl. the no-update tail lookup (mmtf.c:161-175) and a
    stream shorter than one unit."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 9, n, dtype=np.uint8).tobytes()
    enc = md.mmtf_transform(data, lanes=lanes, encode=True, device="cpu")
    assert enc == jmd.mmtf_transform(data, lanes=lanes, encode=True)
    assert enc == mmtf_host._mmtf(data, lanes, encode=True)
    assert md.mmtf_transform(enc, lanes=lanes, encode=False,
                             device="cpu") == data
    assert md.mmtf_transform(b"", lanes=lanes, device="cpu") == b""


@pytest.mark.parametrize("unit", [1, 2])
def test_bitmmtf_matches_jax(unit):
    rng = np.random.default_rng(unit)
    x = rng.integers(0, 256, (2, 64 * unit), dtype=np.uint8)
    enc = md.bitmmtf_encode_device(_t(x), unit=unit)
    np.testing.assert_array_equal(
        enc.numpy(), np.asarray(jmd.bitmmtf_encode_device(jnp.asarray(x),
                                                          unit=unit)))
    dec = md.bitmmtf_decode_device(enc, unit=unit).numpy()
    np.testing.assert_array_equal(dec, x)
    np.testing.assert_array_equal(
        dec, np.asarray(jmd.bitmmtf_decode_device(
            jnp.asarray(enc.numpy()), unit=unit)))
    host = (mmtf_host.bitmmtf8_encode if unit == 1
            else mmtf_host.bitmmtf16_encode)(x[0].tobytes())
    assert enc.numpy()[0].tobytes() == host


def test_mmtf_wrappers_reject_bad_input():
    x = torch.zeros((2, 40), dtype=torch.uint8)
    with pytest.raises(ValueError):
        md.mmtf_device(x, lanes=16)              # 40 % 16 != 0
    with pytest.raises(TypeError):
        md.mmtf_device(x.to(torch.int32), lanes=8)
    with pytest.raises(ValueError):
        md.mmtf_device(x.to("meta"), lanes=8)
    with pytest.raises(ValueError):
        md.bitmmtf_decode_device(x[:, :39], unit=2)


def _le_sample(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 5, n, dtype=np.uint8)
    runs = rng.integers(0, n - 600, 20)
    for s in runs:
        arr[s:s + int(rng.integers(3, 500))] = int(rng.integers(0, 4))
    return arr.tobytes()


@pytest.mark.parametrize("short", [False, True])
def test_le_decompress_device_matches_jax(short):
    data = _le_sample()
    comp = le.le_compress(data, short=short)
    got = led.le_decompress_device(comp, device="cpu")
    assert got == data
    assert got == jled.le_decompress_device(comp)


@pytest.mark.parametrize("subs", [1, 3, 8])
def test_rle8m_decompress_device_matches_jax(subs):
    data = _le_sample(n=9001, seed=subs)
    comp = le.rle8m_compress(subs, data)
    got = led.rle8m_decompress_device(comp, device="cpu")
    assert got == data
    assert got == jled.rle8m_decompress_device(comp)


def test_le_columns_match_jax():
    """The host walk gives the JAX package's columns."""
    comp = le.rle8m_compress(3, _le_sample(n=9001, seed=4))
    cols, B, sizes = led.walk_rle8m(comp)
    buf = memoryview(comp)
    bounds = list(np.frombuffer(comp, "<u4", len(sizes) - 1, 12)) + [
        len(comp)]
    rle, stc, p = led._header(buf, 12 + 4 * (len(sizes) - 1))
    parts = []
    for want, end in zip(sizes, bounds):
        parts.append(jled._parse_section_to_planar(buf, p, want, rle, stc))
        p = int(end)
    pb = jled._stack_planar(parts, sizes)
    for mine, theirs in zip(cols, (pb.sym, pb.count, pb.lit_len, pb.lits,
                                   pb.n_cmds, pb.n_lits, pb.block_len)):
        theirs = np.asarray(theirs)
        w = min(mine.shape[-1], theirs.shape[-1]) if mine.ndim == 2 else None
        np.testing.assert_array_equal(mine[..., :w], theirs[..., :w])
    assert B == -(-max(sizes) // 128) * 128


def test_le_empty_and_hostile():
    empty = np.array([8, 0], "<u4").tobytes()    # header: usize 0
    assert led.le_decompress_device(empty, device="cpu") == b""
    assert led.rle8m_decompress_device(empty + bytes(4), device="cpu") == b""
    comp = le.le_compress(_le_sample())
    with pytest.raises(ValueError):
        led.le_decompress_device(comp[:len(comp) // 2], device="cpu")
    sub = le.rle8m_compress(3, _le_sample(n=9001, seed=2))
    with pytest.raises(ValueError):
        led.rle8m_decompress_device(sub[:len(sub) - 40], device="cpu")
