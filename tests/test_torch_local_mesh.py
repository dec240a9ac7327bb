"""The single-process mesh (``dist.LocalMesh``) vs the JAX package's mesh.

One process drives every device of a LocalMesh, as the JAX package's
``Mesh(jax.devices())`` does: here 4 and 8 named CPU devices (the kernels'
plain versions), against the JAX ``dist`` on conftest's 8-device virtual
CPU mesh cut to the same size.  Bytes and integers: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_dist_rank as R
from hypersonic_rle_kit_tpu import api as japi
from hypersonic_rle_kit_tpu.parallel import container
from hypersonic_rle_kit_tpu.parallel import dist as jdist
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.ops import encode_sup, planar
from hypersonic_rle_kit_tpu_torch.parallel import dist

CAP = planar.capacity_for(R.B, R.MIN_COUNT)
# the streams of test_torch_dist.py, one shorter than a block, and 9 B + 5
# (10 blocks: on 4 devices 3 a share, the last share 1 real block and 2
# all padding; on 8 devices 2 a share, the last 3 shares all padding)
N_BYTES = R.N_BYTES + (1000, 9 * R.B + 5)


@pytest.fixture(params=[4, 8], ids=lambda n: f"cpu{n}")
def n(request):
    return request.param


def _mesh(n):
    return dist.make_mesh(devices=["cpu"] * n)


def _jax_call(fn, x, n):
    lens = np.full(x.shape[0], R.B, np.int32)
    return fn(jnp.asarray(x), jnp.asarray(lens), capacity=CAP,
              min_count=R.MIN_COUNT, mesh=jdist.make_mesh(n))


def _lens(x):
    return torch.full((x.shape[0],), R.B, dtype=torch.int32)


def test_make_mesh_is_a_local_mesh(n):
    mesh = _mesh(n)
    assert isinstance(mesh, dist.LocalMesh)
    assert mesh.size == n and mesh.axis == dist.BLOCK_AXIS
    assert dist.make_mesh(2, "rows", devices=["cpu"] * n).devices == (
        torch.device("cpu"),) * 2


def test_pipeline_step_matches_jax(n):
    x = R.blocks(2 * n, 7)
    y, offsets, sizes = dist.pipeline_step(
        torch.from_numpy(x), _lens(x), capacity=CAP, min_count=R.MIN_COUNT,
        mesh=_mesh(n))
    jy, joff, jsizes = _jax_call(jdist.pipeline_step, x, n)
    assert np.array_equal(y.numpy(), x)
    assert np.array_equal(y.numpy(), np.asarray(jy))
    assert offsets.tolist() == np.asarray(joff).tolist()
    assert sizes.tolist() == np.asarray(jsizes).tolist()
    s = sizes.to(torch.int64)
    assert torch.equal(offsets, torch.cumsum(s, 0) - s)


def test_encode_sharded_matches_jax(n):
    """The tables equal the JAX ones; the shares' columns, in mesh order,
    equal the JAX global columns (numpy input, as a host caller holds)."""
    x = R.blocks(3 * n, 11)
    pbs, sizes, offsets = dist.encode_sharded(
        x, np.full(x.shape[0], R.B, np.int32), capacity=CAP,
        min_count=R.MIN_COUNT, mesh=_mesh(n))
    jpb, jsizes, joff = _jax_call(jdist.encode_sharded, x, n)
    assert len(pbs) == n and all(pb.sym.shape[0] == 3 for pb in pbs)
    assert sizes.tolist() == np.asarray(jsizes).tolist()
    assert offsets.tolist() == np.asarray(joff).tolist()
    for name in ("sym", "count", "lit_len", "lits", "n_cmds", "n_lits"):
        got = torch.cat([getattr(pb, name) for pb in pbs]).numpy()
        assert np.array_equal(got, np.asarray(getattr(jpb, name))), name


@pytest.mark.parametrize("n_bytes", N_BYTES)
def test_compress_distributed_matches_jax(n, n_bytes):
    data = R.stream(n_bytes)
    got = dist.compress_distributed(data, _mesh(n), device="cpu",
                                    block_size=R.B, min_count=R.MIN_COUNT)
    assert got == jdist.compress_distributed(
        data, jdist.make_mesh(n), block_size=R.B, min_count=R.MIN_COUNT)
    assert got == japi.compress(data, block_size=R.B, backend="device")
    assert got == api.compress(data, block_size=R.B, device="cpu")
    assert api.decompress(got, device="cpu") == data


def test_serialize_local_blocks_of_the_shares(n):
    """encode_sharded's shares serialize, with nothing exchanged, to the
    parts of the single-process container (test_multiprocess.py's case in
    one process)."""
    x = R.serialize_blocks_input()
    mesh = _mesh(n)
    pbs, _, _ = dist.encode_sharded(x, np.full(x.shape[0], R.B, np.int32),
                                    capacity=CAP, min_count=R.MIN_COUNT,
                                    mesh=mesh)
    parts, flags = dist.serialize_local_blocks(pbs, R.MIN_COUNT, mesh=mesh)
    assert sorted(parts) == list(range(x.shape[0]))
    blob = container.assemble(0, x.size, R.B,
                              [parts[b] for b in range(x.shape[0])],
                              flags=flags)
    assert blob == japi.compress(x.tobytes(), block_size=R.B,
                                 backend="device")
    # the JAX call form, in a process that has joined no group
    assert dist.serialize_local_blocks(pbs, R.MIN_COUNT) == (parts, flags)


def test_every_share_launches_before_any_check(n, monkeypatch):
    """Every device's encode is issued before the host reads a result
    back: the launches, then one check of them all."""
    order = []
    launch, check = encode_sup.encode_blocks_launch, encode_sup.check_encoded

    def spy_launch(x, *a, **k):
        order.append(("launch", str(x.device)))
        return launch(x, *a, **k)

    def spy_check(probes, **k):
        order.append(("check", len(probes)))
        return check(probes, **k)

    monkeypatch.setattr(encode_sup, "encode_blocks_launch", spy_launch)
    monkeypatch.setattr(encode_sup, "check_encoded", spy_check)
    x = R.blocks(n, 3)
    dist.pipeline_step(x, np.full(n, R.B, np.int32), capacity=CAP,
                       min_count=R.MIN_COUNT, mesh=_mesh(n))
    assert order == [("launch", "cpu")] * n + [("check", n)]


def test_make_mesh_without_a_group_or_a_card_raises(monkeypatch):
    """No CPU mesh by default."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh()


def test_make_mesh_of_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dist.make_mesh().devices == tuple(
        torch.device("cuda", i) for i in range(4))
    assert dist.make_mesh(2).size == 2


@pytest.mark.parametrize("kw", [dict(n_devices=0), dict(n_devices=5),
                                dict(devices=[]),
                                dict(devices=["cpu", "cuda:0"])])
def test_make_mesh_rejects(kw):
    kw.setdefault("devices", ["cpu"] * 4)
    with pytest.raises(ValueError):
        dist.make_mesh(**kw)


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_compress_distributed_device_must_name_the_mesh(device):
    """With a LocalMesh the mesh names the devices; another device
    raises."""
    with pytest.raises(ValueError, match="LocalMesh"):
        dist.compress_distributed(b"\0" * 100, _mesh(4), device=device,
                                  block_size=R.B)


def test_uneven_shares_and_capacity_raise():
    x = R.blocks(6, 1)
    with pytest.raises(ValueError, match="equal shares"):
        dist.pipeline_step(x, np.full(6, R.B, np.int32), capacity=CAP,
                           min_count=R.MIN_COUNT, mesh=_mesh(4))
    with pytest.raises(ValueError, match="capacity"):
        dist.encode_sharded(x[:4], np.full(4, R.B, np.int32), capacity=8,
                            min_count=1, mesh=_mesh(4))
