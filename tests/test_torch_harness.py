"""The port's harness tail on the CPU: the graft entry against the JAX
package's (Pallas in interpret mode), the multi-rank dry run, the device
fuzz lane and the benchmark CLI's HRT1 rows."""

import sys
import time

import numpy as np
import pytest
import torch

import __graft_entry__
from hypersonic_rle_kit_tpu_torch import api, bench_cli, fuzz, graft_entry
from hypersonic_rle_kit_tpu_torch import spec as spec_mod
from hypersonic_rle_kit_tpu_torch.parallel import container


def test_entry_matches_jax():
    fn, args = graft_entry.entry("cpu")
    jfn, jargs = __graft_entry__.entry()
    assert np.array_equal(fn(*args).numpy(), np.asarray(jfn(*jargs)))


_RANK = ("import sys, time; rank = int(sys.argv[3]); "
         "sys.exit(3) if rank == {bad} else time.sleep(60)")


@pytest.mark.parametrize("bad, timeout, error, match", [
    (1, 40, RuntimeError, "rank 1 exited 3"),
    (-1, 2, TimeoutError, "ran past 2 s")])
def test_run_ranks_stops_every_rank(bad, timeout, error, match, tmp_path):
    """A failed rank ends the run at once, its peers killed rather than
    left waiting for it; past the timeout every rank is killed.  (The
    healthy rank would sleep 60 s.)"""
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        graft_entry.run_ranks([sys.executable, "-c", _RANK.format(bad=bad)],
                              2, tmp_path, timeout=timeout)
    assert time.monotonic() - t0 < 30


def test_run_ranks_rank_env(tmp_path):
    """Each rank gets its own variables on top of this environment (the
    two-host layout of chip_smoke.py: a host's cards and LOCAL_RANK)."""
    outs = graft_entry.run_ranks(
        [sys.executable, "-c", "import os; print(os.environ['LOCAL_RANK'], "
         "os.environ['CUDA_VISIBLE_DEVICES'], 'PYTHONPATH' in os.environ)"],
        4, tmp_path, timeout=60,
        rank_env=lambda r: {"LOCAL_RANK": str(r % 2),
                            "CUDA_VISIBLE_DEVICES": "0,1" if r < 2 else "2,3"})
    assert [o.split() for o in outs] == [
        ["0", "0,1", "True"], ["1", "0,1", "True"], ["0", "2,3", "True"],
        ["1", "2,3", "True"]]


def test_dryrun_multichip_cpu(capsys):
    graft_entry.dryrun_multichip(2, "cpu", timeout=180)
    out = capsys.readouterr().out
    assert "scaling (CPU): 1 rank" in out and "; gloo; " in out


def test_dryrun_multichip_cuda_needs_a_card_per_rank():
    """On 'cuda' the dry run is NCCL, one rank per card: more ranks than
    cards raise before any rank starts, never a run on gloo."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="need as many cards"):
        graft_entry.dryrun_multichip(cards + 1, "cuda", timeout=5)


@pytest.mark.parametrize("codec", fuzz.DEVICE_FUZZ_CODECS)
def test_fuzz_lane_clean_cpu(codec, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    logs = []
    failures = fuzz.run_device(fuzz.random_inputs(6, 2),
                               [spec_mod.by_name(codec)], log=logs.append,
                               device="cpu")
    assert failures == 0, logs


def _planted(kind):
    """A decompress that fails the lane in one way."""
    real = api.decompress

    def mismatch(buf, *, device):
        return real(buf, device=device) + b"\0"

    def raise_on_mutated(buf, *, device):
        try:
            return real(buf, device=device)
        except container.ContainerError:
            raise IndexError("planted") from None

    def accept_truncated(buf, *, device):
        try:
            return real(buf, device=device)
        except container.ContainerError:
            return b""

    return {"mismatch": mismatch, "index_error": raise_on_mutated,
            "truncation_accepted": accept_truncated}[kind]


@pytest.mark.parametrize("kind", ["mismatch", "index_error",
                                  "truncation_accepted"])
def test_fuzz_reports_planted_failure(kind, tmp_path, monkeypatch):
    """A decoder that escapes the contract is a failure: a wrong round
    trip, an exception other than ContainerError on a mutated or truncated
    container, or a truncated container accepted."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(api, "decompress", _planted(kind))
    logs = []
    failures = fuzz.run_device(fuzz.random_inputs(6, 3),
                               [spec_mod.by_name("8 Bit")], log=logs.append,
                               device="cpu")
    assert failures == 1 and (tmp_path / "fuzz-failure.bin").exists(), logs


@pytest.mark.parametrize("rejects", [False, True])
def test_fuzz_synchronizes_cuda_decodes(rejects, monkeypatch):
    """Every decode on a CUDA device is closed by a synchronize, a
    rejected container's too, so an asynchronous kernel fault is blamed on
    the input that caused it."""
    synced = []

    def decompress(buf, *, device):
        if rejects:
            raise container.ContainerError("planted")
        return buf

    monkeypatch.setattr(api, "decompress", decompress)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    dev = torch.device("cuda", 0)
    if rejects:
        with pytest.raises(container.ContainerError):
            fuzz._decompress_synced(b"x", dev)
    else:
        assert fuzz._decompress_synced(b"x", dev) == b"x"
    assert synced == [dev]


def test_fuzz_main_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rc = fuzz.main(["--device", "cpu", "--iterative", "--iterations", "2",
                    "--codec", "8 Bit Packed"])
    assert rc == 0 and "fuzz (cpu): clean" in capsys.readouterr().out


def test_fuzz_main_host_lane(tmp_path, monkeypatch, capsys):
    """Without --device the fuzzer runs the host codecs, as the JAX
    package's does."""
    monkeypatch.chdir(tmp_path)
    assert fuzz.main(["--iterations", "5", "--skip-slow"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "fuzz: clean"


@pytest.mark.parametrize("main", [fuzz.main, bench_cli.main])
def test_cli_needs_explicit_device(main, tmp_path):
    """The device lanes name their device: --device takes 'cuda' or
    'cpu' (the fuzzer's host lane is the one without --device)."""
    with pytest.raises(SystemExit):
        main([str(tmp_path / "x.bin")] if main is bench_cli.main
             else ["--device"])


def test_bench_cli_hrt1_test_cpu(tmp_path, capsys):
    rng = np.random.default_rng(0)
    d = rng.integers(-3, 4, 70_001).astype(np.int8).astype(np.uint8)
    d[rng.random(d.size) < 0.8] = 0
    path = tmp_path / "dct.bin"
    path.write_bytes(d.tobytes())
    rc = bench_cli.main([str(path), "--hrt1", "--test", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "HRT1 8 Bit " in out and "FAILED" not in out
