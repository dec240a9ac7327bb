"""Port of parallel/dist.py (torch.distributed) vs the JAX package's.

Each world size starts its gloo ranks once (``tests/torch_dist_rank.py``:
fresh interpreters without JAX, one thread each, a FileStore in a tmp
directory, results pickled to files); the JAX reference values come from
this process's 8-device virtual CPU mesh (conftest.py) cut to the same
world size.  Bytes and integers: the tolerance is zero.
"""

import pickle
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_rank as R
from hypersonic_rle_kit_tpu import api as japi
from hypersonic_rle_kit_tpu.parallel import container
from hypersonic_rle_kit_tpu.parallel import dist as jdist
from hypersonic_rle_kit_tpu_torch import api, graft_entry
from hypersonic_rle_kit_tpu_torch.ops import encode_sup, planar
from hypersonic_rle_kit_tpu_torch.parallel import dist

CAP = planar.capacity_for(R.B, R.MIN_COUNT)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    """(world, [rank 0's results, rank 1's, ...])"""
    world = request.param
    wd = tmp_path_factory.mktemp(f"world{world}")
    graft_entry.run_ranks(
        [sys.executable, str(Path(__file__).with_name("torch_dist_rank.py"))],
        world, wd, timeout=180)
    outs = []
    for r in range(world):
        with open(wd / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return world, outs


def _jax_call(fn, x, world):
    lens = np.full(x.shape[0], R.B, np.int32)
    return fn(jnp.asarray(x), jnp.asarray(lens), capacity=CAP,
              min_count=R.MIN_COUNT, mesh=jdist.make_mesh(world))


def _local_cols(outs, key):
    """The ranks' local columns of ``key``, concatenated in rank order."""
    return [np.concatenate([o[key][0][i] for o in outs]) for i in range(6)]


# ---------------------------------------------------------------------------
# pipeline_step
# ---------------------------------------------------------------------------

def test_pipeline_step_roundtrip(ranks):
    world, outs = ranks
    y = np.concatenate([o["pipeline"][0] for o in outs])
    assert np.array_equal(y, R.blocks(2 * world, 7))


def test_pipeline_step_offsets_are_exclusive_prefix(ranks):
    _, outs = ranks
    offsets = np.concatenate([o["pipeline"][1] for o in outs])
    sizes = np.concatenate([o["pipeline"][2] for o in outs]).astype(np.int64)
    assert np.array_equal(offsets, np.cumsum(sizes) - sizes)


def test_pipeline_step_matches_jax(ranks):
    world, outs = ranks
    _, joff, jsizes = _jax_call(jdist.pipeline_step, R.blocks(2 * world, 7),
                                world)
    got = [np.concatenate([o["pipeline"][i] for o in outs]).tolist()
           for i in (1, 2)]
    assert got == [np.asarray(joff).tolist(), np.asarray(jsizes).tolist()]


# ---------------------------------------------------------------------------
# encode_sharded and the size model
# ---------------------------------------------------------------------------

def test_encode_sharded_matches_local_encode(ranks):
    """The ranks' local columns, in rank order, equal the port's
    single-device encode of the whole input."""
    world, outs = ranks
    x = R.blocks(3 * world, 11)
    ref = encode_sup.encode_blocks_kernel(
        torch.from_numpy(x), torch.full((x.shape[0],), R.B, dtype=torch.int32),
        capacity=CAP, min_count=R.MIN_COUNT)
    got = _local_cols(outs, "encode")
    assert all(np.array_equal(g, r.numpy()) for g, r in zip(got, ref))


def test_encode_sharded_tables_replicated(ranks):
    _, outs = ranks
    tables = [(o["encode"][1].tolist(), o["encode"][2].tolist())
              for o in outs]
    assert all(t == tables[0] for t in tables)


def test_encode_sharded_tables_match_jax(ranks):
    world, outs = ranks
    _, jsizes, joff = _jax_call(jdist.encode_sharded, R.blocks(3 * world, 11),
                                world)
    assert ([outs[0]["encode"][1].tolist(), outs[0]["encode"][2].tolist()]
            == [np.asarray(jsizes).tolist(), np.asarray(joff).tolist()])


def test_size_model_matches_serializer(ranks):
    """The per-block sizes computed on each rank equal the payload bytes
    of the flat serialization of the same columns."""
    world, outs = ranks
    nb = 2 * world
    blob = container.serialize_blocks(0, nb * R.B, R.B, R.MIN_COUNT,
                                      *_local_cols(outs, "model"), deep=False)
    _, blocks = container.parse(blob)
    actual = [bl["payload_bytes"] for bl in blocks]
    assert outs[0]["model"][1].tolist() == actual


@pytest.mark.parametrize("v", [0, 1, 2, 3, 255, 256, 257, 65535, 65536,
                               (1 << 24) - 1, 1 << 24, (1 << 30) - 1, 1 << 30,
                               (1 << 31) - 1])
def test_bit_width_is_exact(v):
    """The size model's bit width (32 - clz) next to powers of two."""
    got = dist._bit_width(torch.tensor([v], dtype=torch.int32))
    assert int(got[0]) == v.bit_length()


# ---------------------------------------------------------------------------
# compress_distributed and serialize_local_blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bytes", R.N_BYTES)
def test_compress_distributed_matches_jax(ranks, n_bytes):
    """16 B is a multiple of every world size; 5 B + 1 pads the block
    count to it, so the last rank's share has all-padding blocks."""
    world, outs = ranks
    data = R.stream(n_bytes)
    assert (outs[0]["compress"][n_bytes]
            == jdist.compress_distributed(data, jdist.make_mesh(world),
                                          block_size=R.B,
                                          min_count=R.MIN_COUNT)
            == japi.compress(data, block_size=R.B, backend="device"))


def test_compress_distributed_same_on_every_rank(ranks):
    _, outs = ranks
    assert all(o["compress"] == outs[0]["compress"] for o in outs)


@pytest.mark.parametrize("n_bytes", R.N_BYTES)
def test_compress_distributed_roundtrip(ranks, n_bytes):
    _, outs = ranks
    assert (api.decompress(outs[0]["compress"][n_bytes], device="cpu")
            == R.stream(n_bytes))


def test_serialize_local_blocks_assemble_to_api_compress(ranks):
    """Every rank's parts, put together by container.assemble, equal the
    single-process container (tests/test_multiprocess.py's case)."""
    _, outs = ranks
    parts, flags = {}, {o["serialize"][1] for o in outs}
    for o in outs:
        parts.update(o["serialize"][0])
    x = R.serialize_blocks_input()
    blob = container.assemble(0, x.size, R.B,
                              [parts[b] for b in range(x.shape[0])],
                              flags=flags.pop())
    assert blob == japi.compress(x.tobytes(), block_size=R.B,
                                 backend="device")


# ---------------------------------------------------------------------------
# bytes on the wire (counted around torch.distributed inside each rank)
# ---------------------------------------------------------------------------

def test_size_exchange_bytes_on_wire(ranks):
    """pipeline_step's only collective is the size all-gather: what each
    rank receives is within 16 bytes per block of the stream."""
    world, outs = ranks
    nb = 2 * world
    wire = [o["wire"] for o in outs]
    assert all(0 < w[("pipeline", "received")] <= 16 * nb
               and ("pipeline", "objects") not in w for w in wire)


def test_stats_and_vote_bytes_on_wire(ranks):
    """serialize_local_blocks sends its width statistics and layout vote,
    at most 1024 bytes per rank, and no column data.  (compress_distributed
    then all-gathers the container parts: those are the result every rank
    returns, not metadata, so they are not held to this bound.)"""
    _, outs = ranks
    wire = [o["wire"] for o in outs]
    assert all(0 < w[("serialize", "sent")] <= 1024
               and ("serialize", "objects") not in w for w in wire)


# ---------------------------------------------------------------------------
# argument checks (no ranks)
# ---------------------------------------------------------------------------

def test_compress_distributed_rejects_wide_codec():
    wide = japi._resolve("32 Bit (Symbol)").index
    with pytest.raises(ValueError, match="width-1"):
        dist.compress_distributed(b"\0" * 100, None, device="cpu",
                                  codec_index=wide)


def test_initialize_multihost_rejects_unknown_backend(tmp_path):
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    with pytest.raises(ValueError, match="backend"):
        dist.initialize_multihost(store, 1, 0, backend="mpi")


def test_initialize_multihost_nccl_needs_cuda(tmp_path):
    """No silent switch to gloo when NCCL cannot run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    with pytest.raises(RuntimeError, match="nccl"):
        dist.initialize_multihost(store, 1, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# each NCCL rank on its own card (no ranks: the choice is a pure function,
# and initialize_multihost is driven against a stand-in CUDA)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank, world, cards, local, local_world, card", [
    (0, 1, 1, None, None, 0),
    (0, 4, 4, None, None, 0),
    (3, 4, 4, None, None, 3),
    (1, 2, 8, None, None, 1),
    (2, 4, 4, 2, None, 2),       # LOCAL_RANK wins where it is set
    (5, 8, 4, 1, 4, 1),          # rank 5 of two hosts of 4 cards
    (6, 8, 4, 2, None, 2),
])
def test_rank_card(rank, world, cards, local, local_world, card):
    assert dist.rank_card(rank, world, cards, local_rank=local,
                          local_world_size=local_world) == card


@pytest.mark.parametrize("rank, world, cards, local, local_world", [
    (0, 2, 1, None, None),       # two ranks, one card
    (3, 4, 2, None, None),
    (5, 8, 4, None, None),       # eight ranks taken to be on one host
    (0, 2, 2, 2, None),          # LOCAL_RANK past the host's cards
    (0, 5, 4, 0, 5),             # five ranks on a host of four cards
    (0, 1, 0, None, None),
])
def test_rank_card_refuses_a_shared_card(rank, world, cards, local,
                                         local_world):
    """NCCL refuses two ranks of one host on one card: ValueError, never a
    switch to gloo."""
    with pytest.raises(ValueError, match="share a card"):
        dist.rank_card(rank, world, cards, local_rank=local,
                       local_world_size=local_world)


@pytest.fixture
def fake_cuda(monkeypatch):
    """A stand-in for 4 cards: initialize_multihost's calls, in order."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **k: calls.append((backend,
                                                           k["rank"])))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    return calls


@pytest.mark.parametrize("env, world, rank, card", [
    ({}, 4, 2, 2), ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, 8, 5, 1)])
def test_initialize_multihost_nccl_sets_the_rank_card(fake_cuda, monkeypatch,
                                                      env, world, rank, card):
    """The rank's card becomes the current device before the group is
    joined, so NCCL ranks at compress_distributed's default device do not
    all compute and exchange on card 0."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    dist.initialize_multihost(None, world, rank, backend="nccl")
    assert fake_cuda == [("set_device", card), ("nccl", rank)]


def test_initialize_multihost_nccl_refuses_a_shared_card(fake_cuda):
    with pytest.raises(ValueError, match="share a card"):
        dist.initialize_multihost(None, 5, 0, backend="nccl")
    assert fake_cuda == []


def test_initialize_multihost_gloo_leaves_the_device(fake_cuda):
    dist.initialize_multihost(None, 8, 5, backend="gloo")
    assert fake_cuda == [("gloo", 5)]


def test_bare_cuda_is_the_current_card(monkeypatch):
    """compress_distributed and the wire resolve a bare "cuda" to the
    current card (the rank's own under NCCL)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert dist._card("cuda") == torch.device("cuda", 3)
    assert dist._card("cuda:1") == torch.device("cuda", 1)
    assert dist._card("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.distributed, "get_backend", lambda m: "nccl")
    assert dist._wire_device(None, torch.device("cuda")) == torch.device(
        "cuda", 3)
