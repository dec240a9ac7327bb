"""The port's counterpart of tests/test_multiprocess.py: two processes join
one group by coordinator address.

Two fresh interpreters without JAX call
``dist.initialize_multihost(coordinator="127.0.0.1:<port>",
num_processes=2, process_id=pid, backend="gloo")``, the JAX package's call
form (process 0 hosts the TCPStore).  Each holds only its half of the 16
blocks of 1024 B (seed 123), encodes it with ``encode_sharded``, serializes
only its own blocks with ``serialize_local_blocks(pb, min_count=6)`` and
writes its parts to a file.  The parent assembles the parts in block order:
the container equals the port's ``api.compress(device="cpu")`` and the JAX
package's ``api.compress``.  At most 1024 B cross the wire while
serializing, and the size exchange moves at most 16 B a block.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_rank as R
from hypersonic_rle_kit_tpu import api as japi
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.parallel import container

_WORKER = r"""
import collections, pickle, sys
import numpy as np
import torch
import torch.distributed as tdist

coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, sys.argv[4])
import torch_dist_rank as R
from hypersonic_rle_kit_tpu_torch.ops import planar
from hypersonic_rle_kit_tpu_torch.parallel import dist

torch.set_num_threads(1)
dist.initialize_multihost(coordinator=coord, num_processes=2,
                          process_id=pid, backend="gloo")
assert tdist.get_world_size() == 2 and tdist.get_rank() == pid

wire = collections.Counter()
phase = ["encode"]
all_gather = tdist.all_gather
def counting(out, t, *a, **k):
    wire[phase[0]] += t.nbytes
    return all_gather(out, t, *a, **k)
tdist.all_gather = counting

x = R.serialize_blocks_input()
half = x.shape[0] // 2
mine = torch.from_numpy(x[pid * half:(pid + 1) * half].copy())
lens = torch.full((half,), R.B, dtype=torch.int32)
mesh = dist.make_mesh()
pb, sizes, offsets = dist.encode_sharded(
    mine, lens, capacity=planar.capacity_for(R.B, 6), min_count=6, mesh=mesh)
phase[0] = "serialize"
parts, flags = dist.serialize_local_blocks(pb, min_count=6)
tdist.all_gather = all_gather
assert "jax" not in sys.modules, "the worker imported jax"
with open(f"{outdir}/part{pid}.pkl", "wb") as f:
    pickle.dump({"parts": parts, "flags": flags, "wire": dict(wire),
                 "sizes": sizes.tolist(), "offsets": offsets.tolist()}, f)
tdist.destroy_process_group()
print("WORKER_OK", pid, len(parts), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_join_by_coordinator(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(tests)] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(pid), str(tmp_path),
         tests], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {pid}" in out, out[-3000:]

    got = []
    for pid in range(2):
        with open(tmp_path / f"part{pid}.pkl", "rb") as f:
            got.append(pickle.load(f))
    parts = {}
    for g in got:
        parts.update(g["parts"])
    x = R.serialize_blocks_input()
    nb = x.shape[0]
    assert sorted(parts) == list(range(nb))
    assert got[0]["flags"] == got[1]["flags"]
    for g in got:
        assert 0 < g["wire"]["serialize"] <= 1024, g["wire"]
        assert 0 < g["wire"]["encode"] <= 16 * nb, g["wire"]
        assert g["sizes"] == got[0]["sizes"] and len(g["sizes"]) == nb
    sizes = np.array(got[0]["sizes"], np.int64)
    assert got[0]["offsets"] == (np.cumsum(sizes) - sizes).tolist()

    payload = x.tobytes()
    blob = container.assemble(0, x.size, R.B, [parts[b] for b in range(nb)],
                              flags=got[0]["flags"])
    assert blob == api.compress(payload, block_size=R.B, device="cpu")
    assert blob == japi.compress(payload, block_size=R.B, backend="device")
    assert api.decompress(blob, device="cpu") == payload


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "2", "RANK": "1"}])
def test_initialize_multihost_without_a_meeting_place_does_nothing(
        monkeypatch, env):
    """As the JAX call does in one process: no coordinator, no store and
    no MASTER_ADDR / MASTER_PORT -> nothing joined."""
    import torch.distributed as tdist
    from hypersonic_rle_kit_tpu_torch.parallel import dist
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    dist.initialize_multihost()
    dist.initialize_multihost(num_processes=2, process_id=0, backend="gloo")
    assert calls == [] and not tdist.is_initialized()


def test_initialize_multihost_reads_torchrun_environment(monkeypatch):
    """With neither a coordinator nor a store, torchrun's variables say
    where to meet (init_method env://) and, where the call does not, the
    world size and rank."""
    import torch.distributed as tdist
    from hypersonic_rle_kit_tpu_torch.parallel import dist
    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500",
                 "WORLD_SIZE": "4", "RANK": "3"}.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda backend, **k: calls.append((backend, k)))
    dist.initialize_multihost(backend="gloo")
    dist.initialize_multihost(num_processes=2, process_id=1, backend="gloo")
    assert [(b, k["init_method"], k["world_size"], k["rank"])
            for b, k in calls] == [("gloo", "env://", 4, 3),
                                   ("gloo", "env://", 2, 1)]


def test_initialize_multihost_refuses_a_coordinator_and_a_store():
    import torch.distributed as tdist
    from hypersonic_rle_kit_tpu_torch.parallel import dist
    with pytest.raises(ValueError, match="not both"):
        dist.initialize_multihost("127.0.0.1:1", 1, 0, backend="gloo",
                                  store=tdist.HashStore())
