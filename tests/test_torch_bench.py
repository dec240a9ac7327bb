"""The port's bench (``hypersonic_rle_kit_tpu_torch/bench.py``) on the CPU.

Run as ``python -m hypersonic_rle_kit_tpu_torch.bench --device cpu`` at
1 MiB in 64 KiB blocks, one iteration: it prints one JSON line with the
repository's ``bench.py`` keys (``stage_ms`` has no counterpart) plus the
walls; its ratios equal, exactly, the ones ``bench.py``'s lines compute
with the JAX package's host modules on the same corpora; a failed round
trip raises and prints no line; without ``--device cpu`` and without a
card it exits non-zero before it measures anything.  The times are host
clock on the kernels' plain versions, checked only for being positive.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from hypersonic_rle_kit_tpu import api as japi
from hypersonic_rle_kit_tpu.ops import planar as jplanar
from hypersonic_rle_kit_tpu.parallel import container as jcontainer
from hypersonic_rle_kit_tpu.utils import native as jnative
from hypersonic_rle_kit_tpu_torch import bench
from hypersonic_rle_kit_tpu_torch.ops import unpack_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
MIB, BLOCK = 1, 65536
ARGV = ["--device", "cpu", "--mib", str(MIB), "--block", str(BLOCK),
        "--iters", "1"]
# bench.py's extra_keys (bench.py:546-555) but stage_ms
EXTRA_KEYS = ("encode_kernel_gbps", "host_unpack_gbps", "h2d_gbps",
              "h2d_payload_gbps", "host_pack_gbps", "decode_columns_gbps",
              "decode_e2e_gbps", "encode_host_gbps", "ratio", "ratio_flat",
              "decode_flat_gbps", "ratio_random", "decode_random_gbps",
              "ratio_bwt", "decode_bwt_gbps", "ratio_sh", "decode_sh_gbps",
              "ratio_w64", "decode_w64_gbps", "ref_ingest_gbps")
SPLITS = {"compress_split_ms": ("to_blocks_h2d", "encode", "d2h",
                                "serialize"),
          "decompress_split_ms": ("parse_pack", "h2d", "device", "d2h",
                                  "to_bytes"),
          "decompress_small_ms": ("64KiB", "1MiB")}


def _bench(*argv: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "hypersonic_rle_kit_tpu_torch.bench", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def line() -> dict:
    proc = _bench(*ARGV)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def test_bench_prints_one_line_with_every_key(line):
    assert line["metric"] == "rle8_device_decode_compressed_input"
    assert line["unit"] == "GB/s"
    assert line["ok"] is True
    assert line["device"] == "cpu"
    assert line["device_ms"] is None           # not measured off the card
    assert line["value"] == line["gbps"] > 0
    assert line["vs_baseline"] == line["gbps"] / bench.BASELINE_DECODE_GBPS
    missing = [k for k in EXTRA_KEYS + ("compress_wall_ms",
                                        "decompress_wall_ms", *SPLITS)
               if k not in line]
    assert not missing, missing
    assert "stage_ms" not in line
    gbps = {k: v for k, v in line.items() if k.endswith("_gbps")}
    assert len(gbps) == 14
    assert all(v > 0 for v in gbps.values()), gbps
    assert line["compress_wall_ms"] > 0 and line["decompress_wall_ms"] > 0
    for key, stages in SPLITS.items():
        assert tuple(line[key]) == stages, key
        assert all(v > 0 for v in line[key].values()), line[key]


def _jax_ratio(key: str) -> float:
    """bench.py's ratio lines (:213-214, :280-283, :398-399, :429-430) with
    the JAX package's native encoder, serializer and api.compress."""
    if key in ("ratio", "ratio_flat", "ratio_w64"):
        data = jbench.make_dataset(MIB)
    else:
        data = getattr(jbench, f"make_{key[6:]}_dataset")(min(16, MIB))
    nb = data.size // BLOCK
    n = nb * BLOCK
    if key == "ratio_w64":
        return len(japi.compress(data[:n], "64 Bit Packed (Byte)")) / n
    cols = jnative.planar_from_bytes(data[:n].reshape(nb, BLOCK),
                                     np.full(nb, BLOCK, np.int32),
                                     jplanar.capacity_for(BLOCK, 6))
    kw = {"deep": False} if key == "ratio_flat" else {}
    return len(jcontainer.serialize_blocks(0, n, BLOCK, 6, *cols, **kw)) / n


@pytest.mark.parametrize("key", ["ratio", "ratio_flat", "ratio_random",
                                 "ratio_bwt", "ratio_sh", "ratio_w64"])
def test_bench_ratios_equal_jax_package(line, key):
    if jnative.lib() is None:
        pytest.skip("the JAX package's native runtime does not build")
    assert line[key] == _jax_ratio(key)


def test_bench_raises_on_a_failed_round_trip(monkeypatch, capsys):
    def zeros(pk, arrs, **kw):
        info = pk["info"]
        return torch.zeros((info.n_blocks, info.block_size // 4),
                           dtype=torch.int32)

    monkeypatch.setattr(unpack_device, "dispatch_packed", zeros)
    with pytest.raises(RuntimeError, match="round trip"):
        bench.main(ARGV)
    assert capsys.readouterr().out == ""


def test_bench_without_a_card_exits_before_measuring():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    proc = _bench("--quick")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is false" in proc.stderr
