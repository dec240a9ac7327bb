"""Entry points of the port: the main-path decode step, a local launcher of
ranks, and the multi-rank dry run.

Port of the repository's ``__graft_entry__.py``:

- :func:`entry` returns the decode step (compressed planar columns ->
  bytes, the hrt1_decode kernel on CUDA) and its example arguments;
- :func:`run_ranks` starts ranks as fresh interpreters that meet through
  a ``FileStore``;
- :func:`dryrun_multichip` runs the distributed compress -> size exchange
  -> decompress step, the ordered reassembly and one weak-scaling
  measurement over ``n`` ranks:

      python -c "from hypersonic_rle_kit_tpu_torch import graft_entry;
                 graft_entry.dryrun_multichip(2, 'cuda')"

On 'cuda' the ranks are NCCL ranks, one per card; on 'cpu' gloo ranks.
"""

from __future__ import annotations

import functools
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_REPO = pathlib.Path(__file__).resolve().parents[1]


def entry(device="cuda"):
    """Return ``(fn, args)``: the decode step on two 16 KiB blocks (half
    zeros, half bytes 0..3), the columns on ``device``."""
    from .ops import decode_sup, planar

    B, NB = 16384, 2
    rng = np.random.default_rng(0)
    data = rng.integers(0, 4, (NB, B), dtype=np.uint8)
    data[:, : B // 2] = 0
    lens = np.full(NB, B, np.int32)
    cap = planar.capacity_for(B, 6)
    outs = [planar.host_encode_block(data[b], cap, B, 6) for b in range(NB)]
    cols = ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])
    fn = functools.partial(decode_sup.decode_columns_device, block_size=B)
    return fn, tuple(decode_sup.columns_to_device(cols + [lens], device))


def run_ranks(cmd: list[str], world: int, workdir, *, timeout: float,
              rank_env=None) -> list[str]:
    """Run ``cmd + [workdir, world, rank]`` for each rank, each a fresh
    interpreter (never a fork of this process, which may hold a CUDA
    context), with the repository on ``PYTHONPATH`` and, where
    ``rank_env(rank)`` is given, its variables (a rank's visible cards
    and ``LOCAL_RANK``, say, to lay the ranks out as several hosts).  The
    ranks meet where ``cmd`` says, e.g. a FileStore at ``workdir/store``.

    Returns each rank's output (stdout and stderr).  Raises RuntimeError
    if a rank exits non-zero (the ranks still running, which would wait
    for it, are killed at once) and TimeoutError past ``timeout`` seconds
    (every rank still running is killed)."""
    workdir = pathlib.Path(workdir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    logs = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [*cmd, str(workdir), str(world), str(r)],
                    env={**env, **(rank_env(r) if rank_env else {})},
                    cwd=_REPO, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {cmd[:3]} ran past "
                                   f"{timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    bad = [f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
           for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise RuntimeError("\n".join(bad))
    return outs


def dryrun_multichip(n_devices: int, device: str = "cuda", *,
                     timeout: float = 600.0) -> None:
    """The distributed step over ``n_devices`` ranks, each a fresh
    interpreter: on 'cuda' NCCL ranks, rank r on card r (ValueError if
    there are fewer cards than ranks), on 'cpu' gloo ranks.  Checks the
    ``pipeline_step`` round trip, offsets equal to the exclusive prefix of
    the sizes, ``compress_distributed`` bytes equal to
    ``api.compress(backend="device")`` and round-tripping, and prints one
    line of blocks/s for 1 rank and for ``n_devices`` ranks.  Raises if a
    rank fails."""
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > cards:
            raise ValueError(f"{n_devices} NCCL ranks need as many cards; "
                             f"this host has {cards}")
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    with tempfile.TemporaryDirectory() as wd:
        outs = run_ranks([sys.executable, "-m", __name__, device],
                         n_devices, wd, timeout=timeout)
    print(next(ln for ln in outs[0].splitlines() if ln.startswith("scaling")))


def _dryrun_rank(device: str, workdir: str, world: int, rank: int) -> None:
    import torch.distributed as tdist

    from . import api
    from .ops import planar, transfer
    from .parallel import dist

    torch.set_num_threads(1)
    backend = "nccl" if device == "cuda" else "gloo"
    dist.initialize_multihost(
        num_processes=world, process_id=rank, backend=backend,
        store=tdist.FileStore(f"{workdir}/store", world))
    if device == "cuda":        # the rank's card, made current on joining
        dev = torch.device("cuda", torch.cuda.current_device())
        label = torch.cuda.get_device_name(dev)
    else:
        dev, label = torch.device(device), "CPU"
    mesh = dist.make_mesh(world)
    B, per_rank = 1024, 2
    cap = planar.capacity_for(B, 6)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 3, (per_rank * world, B), dtype=np.uint8)
    x[:, ::2] = 0
    lens = np.full(x.shape[0], B, np.int32)
    mine = slice(rank * per_rank, (rank + 1) * per_rank)

    def put(a):
        return transfer.to_device(np.ascontiguousarray(a), dev)

    y, offsets, sizes = dist.pipeline_step(put(x[mine]), put(lens[mine]),
                                           capacity=cap, min_count=6,
                                           mesh=mesh)
    if not torch.equal(y.cpu(), torch.from_numpy(x[mine])):
        raise AssertionError("distributed round trip mismatch")
    got = [None] * world
    tdist.all_gather_object(got, (sizes.cpu(), offsets.cpu()), group=mesh)
    all_sizes = torch.cat([s for s, _ in got]).long()
    if not torch.equal(torch.cat([o for _, o in got]),
                       torch.cumsum(all_sizes, 0) - all_sizes):
        raise AssertionError("offsets != exclusive prefix of the sizes")

    # ordered reassembly: distributed bytes == single-process bytes
    data = x.reshape(-1).tobytes()
    blob = dist.compress_distributed(data, mesh, block_size=B, device=dev)
    if blob != api.compress(data, block_size=B, backend="device", device=dev):
        raise AssertionError("distributed container bytes differ from the "
                             "single-process serialization")
    if api.decompress(blob, device=dev) != data:
        raise AssertionError("distributed container does not round-trip")

    # weak scaling: 1 rank on k blocks, then every rank on k blocks each
    k, reps = 256, 4
    xs = put(np.tile(x, (-(-k // x.shape[0]), 1))[:k])
    ls = put(np.full(k, B, np.int32))

    def rate(m) -> float:
        dist.pipeline_step(xs, ls, capacity=cap, min_count=6, mesh=m)
        tdist.barrier(group=m)
        t0 = time.perf_counter()
        for _ in range(reps):
            y = dist.pipeline_step(xs, ls, capacity=cap, min_count=6,
                                   mesh=m)[0]
        y.cpu()
        walls = [None] * tdist.get_world_size(m)
        tdist.all_gather_object(walls, time.perf_counter() - t0, group=m)
        return reps * k * len(walls) / max(walls)

    one = dist.make_mesh(1)             # a collective: every rank joins
    r1 = rate(one) if rank == 0 else 0.0
    tdist.barrier()
    rn = rate(mesh)
    if rank == 0:
        cores = os.cpu_count() or 1
        where = (f"{world} CPU processes of one thread sharing {cores} cores"
                 if dev.type == "cpu" else
                 f"{world} ranks, one per card, of "
                 f"{torch.cuda.device_count()} card(s)")
        print(f"scaling ({label}): 1 rank {r1:.0f} blocks/s, {world} ranks "
              f"{rn:.0f} blocks/s, weak-scaling efficiency "
              f"{100 * rn / (r1 * world):.0f}% of linear ({where}; "
              f"{backend}; {B}-byte blocks)", flush=True)
    tdist.destroy_process_group()


if __name__ == "__main__":
    _dryrun_rank(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
