"""One gloo rank of tests/test_torch_dist.py, and the inputs both sides use.

    python tests/torch_dist_rank.py WORKDIR WORLD RANK

Runs the port's ``parallel/dist.py`` on this rank's slice of each input
(CPU tensors, one thread, a FileStore in WORKDIR) and pickles what the
tests compare to ``WORKDIR/rank<RANK>.pkl``.  Imports no JAX.  Every
collective the port makes is counted by phase: bytes this rank sends and
receives through ``all_gather``, and the pickled size of what it gathers
through ``all_gather_object``.
"""

from __future__ import annotations

import collections
import pickle
import sys

import numpy as np

B = 1024
MIN_COUNT = 6
N_BYTES = (B * 16, B * 16 - 333, B * 5 + 1)
SERIALIZE_NB, SERIALIZE_SEED = 16, 123


def blocks(nb: int, seed: int) -> np.ndarray:
    """The block inputs of tests/test_dist.py."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 5, (nb, B), dtype=np.uint8)
    x[:, ::3] = 0
    x[:, 100:200] = 9
    return x


def serialize_blocks_input() -> np.ndarray:
    """The block input of tests/test_multiprocess.py."""
    rng = np.random.default_rng(SERIALIZE_SEED)
    x = rng.integers(0, 5, (SERIALIZE_NB, B), dtype=np.uint8)
    x[:, ::3] = 0
    return x


def stream(n_bytes: int) -> bytes:
    """The byte streams of test_dist.test_compress_distributed_byte_equal."""
    rng = np.random.default_rng(n_bytes)
    data = rng.integers(0, 4, n_bytes, dtype=np.uint8)
    data[rng.random(n_bytes) < 0.6] = 0
    return data.tobytes()


def _cols(pb) -> list[np.ndarray]:
    return [getattr(pb, f).numpy().copy() for f in
            ("sym", "count", "lit_len", "lits", "n_cmds", "n_lits")]


def main(workdir: str, world: int, rank: int) -> None:
    import torch
    import torch.distributed as tdist

    from hypersonic_rle_kit_tpu_torch.ops import planar
    from hypersonic_rle_kit_tpu_torch.parallel import dist

    torch.set_num_threads(1)
    wire = collections.Counter()
    phase = ["setup"]
    all_gather, all_gather_object = tdist.all_gather, tdist.all_gather_object

    def counting_all_gather(out, t, *a, **k):
        wire[phase[0], "sent"] += t.nbytes
        wire[phase[0], "received"] += t.nbytes * len(out)
        return all_gather(out, t, *a, **k)

    def counting_all_gather_object(out, obj, *a, **k):
        wire[phase[0], "objects"] += len(pickle.dumps(obj))
        return all_gather_object(out, obj, *a, **k)

    tdist.all_gather = counting_all_gather
    tdist.all_gather_object = counting_all_gather_object

    dist.initialize_multihost(
        num_processes=world, process_id=rank, backend="gloo",
        store=tdist.FileStore(f"{workdir}/store", world), timeout=60)
    mesh = dist.make_mesh()
    cap = planar.capacity_for(B, MIN_COUNT)
    kw = dict(capacity=cap, min_count=MIN_COUNT, mesh=mesh)

    def mine(x):
        per = x.shape[0] // world
        xs = torch.from_numpy(x[rank * per:(rank + 1) * per].copy())
        return xs, torch.full((per,), B, dtype=torch.int32)

    out = {}
    phase[0] = "pipeline"
    y, offsets, sizes = dist.pipeline_step(*mine(blocks(2 * world, 7)), **kw)
    out["pipeline"] = (y.numpy(), offsets.numpy(), sizes.numpy())
    phase[0] = "encode"
    pb, all_sizes, offsets = dist.encode_sharded(*mine(blocks(3 * world, 11)),
                                                 **kw)
    out["encode"] = (_cols(pb), all_sizes.numpy(), offsets.numpy())
    pb, all_sizes, _ = dist.encode_sharded(*mine(blocks(2 * world, 13)), **kw)
    out["model"] = (_cols(pb), all_sizes.numpy())
    pb, _, _ = dist.encode_sharded(*mine(serialize_blocks_input()), **kw)
    phase[0] = "serialize"
    out["serialize"] = dist.serialize_local_blocks(pb, min_count=MIN_COUNT,
                                                   mesh=mesh)
    phase[0] = "compress"
    out["compress"] = {n: dist.compress_distributed(
        stream(n), mesh, block_size=B, min_count=MIN_COUNT, device="cpu")
        for n in N_BYTES}
    out["wire"] = dict(wire)
    tdist.destroy_process_group()
    with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
