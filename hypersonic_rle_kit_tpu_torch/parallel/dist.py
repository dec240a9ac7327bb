"""Multi-device / multi-host distribution of the block codec.

Port of hypersonic_rle_kit_tpu/parallel/dist.py.  A mesh is one of two
things, and every entry point takes either:

- a :class:`LocalMesh`, the counterpart of the JAX package's
  ``Mesh(jax.devices())``: one process drives every device it names.  The
  block axis is split into equal contiguous shares, share i on device i;
  each share is encoded by hrt1_encode (and, in :func:`pipeline_step`,
  decoded by hrt1_decode) on its own card, every card's launch issued
  before the host reads anything back, and the per-card size vectors are
  copied to the first device (peer copies, no process group) where the
  exclusive prefix is formed.  :func:`compress_distributed` brings the
  shares' columns to the host and serializes once, as the JAX single
  controller does.
- a ``torch.distributed`` process group: one rank per device, each
  holding its own contiguous slice of the block axis on its own device.
  The JAX package's ``shard_map`` bodies become the code every rank runs
  on its slice: each rank encodes its blocks and decodes them; the
  per-block compressed sizes are exchanged with one ``all_gather`` and an
  exclusive prefix sum over them gives every block's byte offset in the
  final container; a multi-host serialization exchanges only summable
  width statistics and a three-way layout vote (a few hundred bytes per
  rank), so every rank picks the same widths and layout and the assembled
  container equals the single-process ``api.compress`` bytes.

:func:`make_mesh` gives the group where the process has joined one
(:func:`initialize_multihost`), else the LocalMesh of the visible cards.
Collectives run on the backend's device, and the small size and statistics
vectors move there in one explicit step: NCCL exchanges CUDA tensors (a
rank whose data is on the CPU cannot use it), gloo exchanges CPU tensors
(whatever device the rank computes on).  Under NCCL each rank of a host has
a card of its own (:func:`rank_card`), made the current device when it
joins, so a bare ``"cuda"`` is that card.  Nothing switches backend or
device behind the caller's back, and there is never a CPU mesh by default.

Tests run ranks as CPU processes on gloo (``tests/test_torch_dist.py``) and
LocalMeshes of named CPU devices (``tests/test_torch_local_mesh.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

from .. import api, spec as spec_mod
from ..ops import decode_sup, encode_sup, planar
from ..ops.planar import PlanarBlocks
from ..ops.transfer import to_device
from . import container

_I32 = torch.int32
BLOCK_AXIS = "blocks"


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """One process's mesh over the devices it drives, share ``i`` of the
    block axis on ``devices[i]``; ``axis`` names the block axis, as the
    JAX package's mesh does."""

    devices: tuple[torch.device, ...]
    axis: str = BLOCK_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS, *,
              devices=None):
    """The mesh of the block axis over ``n_devices`` devices (default all).

    A process that has joined a group (:func:`initialize_multihost`) and
    names no ``devices`` gets the world group, or a group of its first
    ``n_devices`` ranks (creating a sub-group is a collective: every rank
    of the world calls this; ranks outside it get
    ``GroupMember.NON_GROUP_MEMBER``).  Any other process gets a
    :class:`LocalMesh` of the first ``n_devices`` of ``devices``, by
    default the visible cards ``cuda:0``, ``cuda:1``, ...; without a card
    it raises RuntimeError (there is no CPU mesh unless ``devices`` names
    CPU devices)."""
    if devices is None and tdist.is_initialized():
        world = tdist.get_world_size()
        if n_devices is None or n_devices == world:
            return tdist.group.WORLD
        if not 1 <= n_devices <= world:
            raise ValueError(f"n_devices {n_devices} outside [1, {world}]")
        return tdist.new_group(list(range(n_devices)))
    if devices is None:
        n = torch.cuda.device_count()
        if not n:
            raise RuntimeError("make_mesh: no process group joined and no "
                               "CUDA device visible; name the devices "
                               "(devices=[...]) for a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(_card(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices {n_devices} outside "
                             f"[1, {len(devices)}]")
        devices = devices[:n_devices]
    if not devices or len({d.type for d in devices}) != 1:
        raise ValueError(f"a LocalMesh needs devices of one type, got "
                         f"{devices}")
    return LocalMesh(devices, axis)


def _card(dev) -> torch.device:
    """``dev`` as a device; a bare ``"cuda"`` becomes the current card (the
    rank's own under NCCL, see :func:`initialize_multihost`)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _wire_device(mesh, dev: torch.device) -> torch.device:
    """The device the mesh's backend exchanges tensors on, for a rank that
    computes on ``dev``."""
    backend = tdist.get_backend(mesh)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl" and dev.type == "cuda":
        return _card(dev)
    raise ValueError(f"the {backend!r} backend cannot exchange the tensors "
                     f"of a rank on {dev}")


def _all_gather(t: torch.Tensor, mesh, dev: torch.device) -> torch.Tensor:
    """Every rank's ``t`` (same shape on all), concatenated along dim 0 in
    rank order, on ``t``'s device; exchanged on the backend's device."""
    w = t.to(_wire_device(mesh, dev))
    out = [torch.empty_like(w) for _ in range(tdist.get_world_size(mesh))]
    tdist.all_gather(out, w, group=mesh)
    return torch.cat(out).to(t.device)


def _all_gather_objects(obj, mesh, dev: torch.device) -> list:
    """Every rank's picklable ``obj``, in rank order.  NCCL stages the
    pickled bytes on the current CUDA device, so that is set to the
    rank's."""
    out = [None] * tdist.get_world_size(mesh)
    wire = _wire_device(mesh, dev)
    with (torch.cuda.device(wire) if wire.type == "cuda"
          else contextlib.nullcontext()):
        tdist.all_gather_object(out, obj, group=mesh)
    return out


def _bit_width(v: torch.Tensor) -> torch.Tensor:
    """Bits needed for each non-negative int32 in ``v`` (``32 - clz(v)``),
    exact: a float log2 rounds wrong next to powers of two.  The powers of
    two 2^0 .. 2^30 are made on ``v``'s device: a copy from the host would
    wait for the card's queued work."""
    k = torch.arange(31, dtype=_I32, device=v.device)
    pow2 = torch.ones_like(k).bitwise_left_shift(k)
    return torch.searchsorted(pow2, v.to(_I32).contiguous(), right=True,
                              out_int32=True)


def _sizes(pb: PlanarBlocks, min_count: int) -> torch.Tensor:
    """Each block's serialized payload size in the flat layout (bit-packed
    counts and lit_lens at the block's own widths, run symbols, literals),
    on the blocks' device."""
    n_runs = pb.n_cmds - 1
    cnt_w = _bit_width((pb.count.amax(1) - min_count).clamp(min=0))
    lit_w = _bit_width(pb.lit_len.amax(1))
    return ((cnt_w * n_runs + 7) // 8 + (lit_w * pb.n_cmds + 7) // 8
            + n_runs + pb.n_lits)


def _encode_local(x, block_len, *, capacity: int, min_count: int):
    """Encode this rank's ``[nb, B]`` blocks; returns the planar blocks and
    each block's serialized payload size (:func:`_sizes`)."""
    pb = PlanarBlocks(*encode_sup.encode_blocks_kernel(
        x, block_len, capacity=capacity, min_count=min_count), block_len)
    return pb, _sizes(pb, min_count)


def _put(a, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``dev`` (from the host through a pinned
    buffer, from another card by a peer copy), contiguous."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            return a.to(dev, non_blocking=True).contiguous()
        a = a.numpy()
    return to_device(np.ascontiguousarray(a), dev)


def _encode_shares(x, block_len, mesh: LocalMesh, *, capacity: int,
                   min_count: int) -> list[PlanarBlocks]:
    """The ``[nb, B]`` blocks (numpy or a tensor on any device) in
    ``mesh.size`` equal contiguous shares, share i copied to and encoded
    on device i.  Every device's launch is issued before the host reads
    anything; then one read checks them all (the encoder's ValueErrors)."""
    nb, B = x.shape
    if nb % mesh.size:
        raise ValueError(f"{nb} blocks do not split into {mesh.size} equal "
                         f"shares")
    per = nb // mesh.size
    launched = []
    for i, dev in enumerate(mesh.devices):
        share = slice(i * per, (i + 1) * per)
        xs, ls = _put(x[share], dev), _put(block_len[share], dev)
        cols, probe = encode_sup.encode_blocks_launch(
            xs, ls, capacity=capacity, min_count=min_count)
        launched.append((PlanarBlocks(*cols, ls), probe))
    encode_sup.check_encoded([p for _, p in launched], capacity=capacity,
                             block_size=B)
    return [pb for pb, _ in launched]


def _to_first(mesh: LocalMesh, ts) -> torch.Tensor:
    """The tensors of every share, concatenated along dim 0 on the mesh's
    first device (peer copies)."""
    return torch.cat([t.to(mesh.devices[0], non_blocking=True) for t in ts])


def _shares_to_host(pbs) -> list[np.ndarray]:
    """The planar columns of the shares, in order, as numpy ``(sym, count,
    lit_len, lits, n_cmds, n_lits)`` (``api._shares_to_host``)."""
    return api._shares_to_host([(pb.sym, pb.count, pb.lit_len, pb.lits,
                                 pb.n_cmds, pb.n_lits) for pb in pbs])


def _decode(pb: PlanarBlocks, block_size: int) -> torch.Tensor:
    return decode_sup.decode_columns_device(
        pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits,
        pb.block_len, block_size=block_size)


def _local_sizes(mesh: LocalMesh, pbs, min_count: int):
    """Every share's per-block sizes, gathered on the mesh's first device,
    and their exclusive prefix sum, the global byte offsets (int64)."""
    sizes = _to_first(mesh, [_sizes(pb, min_count) for pb in pbs])
    return sizes, torch.cumsum(sizes, 0, dtype=torch.int64) - sizes


def _exchange_sizes(size: torch.Tensor, mesh):
    """All ranks' per-block sizes (the only collective of the encode step)
    and their exclusive prefix sum, the global byte offsets (int64)."""
    all_sizes = _all_gather(size, mesh, size.device)
    offsets = torch.cumsum(all_sizes, 0, dtype=torch.int64) - all_sizes
    return all_sizes, offsets


def pipeline_step(x, block_len, *, capacity: int, min_count: int, mesh):
    """One compress -> size-exchange -> decompress step over the mesh.

    With a :class:`LocalMesh`, ``x: [nb, B] uint8`` and ``block_len: [nb]
    int32`` are the whole block axis (numpy or tensors on any device; ``nb``
    a multiple of the mesh size); each share is encoded and decoded on its
    own device.  Returns ``(decoded blocks [nb, B], global byte offsets
    [nb] int64, compressed sizes [nb])``, all on the mesh's first device.

    With a process group they are this rank's slice of the block axis (the
    same ``nb`` on every rank), on its device, and the result is this
    slice's ``(decoded blocks, global byte offsets, compressed sizes)``."""
    if isinstance(mesh, LocalMesh):
        pbs = _encode_shares(x, block_len, mesh, capacity=capacity,
                             min_count=min_count)
        ys = [_decode(pb, x.shape[1]) for pb in pbs]
        sizes, offsets = _local_sizes(mesh, pbs, min_count)
        return _to_first(mesh, ys), offsets, sizes
    pb, size = _encode_local(x, block_len, capacity=capacity,
                             min_count=min_count)
    _, offsets = _exchange_sizes(size, mesh)
    y = _decode(pb, x.shape[1])
    nb = x.shape[0]
    first = tdist.get_rank(mesh) * nb
    return y, offsets[first:first + nb], size


def encode_sharded(x, block_len, *, capacity: int, min_count: int, mesh):
    """Encode with a sizes-only exchange: only the per-block serialized
    sizes (4 bytes per block) cross between devices, and the global offset
    table is derived from them: O(n_blocks) metadata moves, never the
    O(stream) column data.

    With a :class:`LocalMesh` (``x``, ``block_len`` the whole block axis,
    as in :func:`pipeline_step`) each share's columns stay on its device:
    returns ``(a PlanarBlocks per share, in mesh order, all sizes [nb], all
    offsets [nb] int64)``, the two tables on the mesh's first device.

    With a process group each rank encodes its slice and keeps its
    columns: returns ``(this rank's PlanarBlocks, all sizes, all
    offsets)``, the two tables the same on every rank."""
    if isinstance(mesh, LocalMesh):
        pbs = _encode_shares(x, block_len, mesh, capacity=capacity,
                             min_count=min_count)
        return (pbs, *_local_sizes(mesh, pbs, min_count))
    pb, size = _encode_local(x, block_len, capacity=capacity,
                             min_count=min_count)
    all_sizes, offsets = _exchange_sizes(size, mesh)
    return pb, all_sizes, offsets


def serialize_local_blocks(pb, min_count: int = 6, deep: bool | str = "auto",
                           *, mesh=None, first_block: int | None = None
                           ) -> tuple[dict[int, tuple], int]:
    """Serialize only the blocks this process holds.

    ``pb`` is a PlanarBlocks, or the list of shares that
    :func:`encode_sharded` returns for a :class:`LocalMesh`; its first block
    is block ``first_block`` of the stream.  ``mesh`` is the process group
    the blocks are split over (None: the world group where the process has
    joined one) and then ``first_block`` defaults to rank x the local block
    count; with a LocalMesh, or in a process that has joined no group, this
    process holds the whole stream, ``first_block`` defaults to 0 and
    nothing is exchanged.

    Returns ``({block_index: (table_entry, payload_bytes)}, flags)``; the
    parts of all ranks put in block order by :func:`container.assemble`
    (with the same ``flags``) equal the single-process ``api.compress``
    bytes.  What crosses the group is the summable width statistics
    (``container.two_tier_stats``, 77 int64 per rank) and, for the deep
    layouts, a three-way size vote (3 int64): every rank picks the same
    container-uniform widths and the same flat / deep / litdict layout."""
    shares = list(pb) if isinstance(pb, (list, tuple)) else [pb]
    group = None
    if not isinstance(mesh, LocalMesh) and (mesh is not None
                                            or tdist.is_initialized()):
        group = tdist.group.WORLD if mesh is None else mesh
    dev = shares[0].sym.device
    nb = sum(s.sym.shape[0] for s in shares)
    if first_block is None:
        first_block = 0 if group is None else tdist.get_rank(group) * nb
    local = []                          # (block_index, arrays, nc, nl)
    if nb:
        sym, count, lit_len, lits, nc, nl = _shares_to_host(shares)
        local = [(first_block + j, (sym[j], count[j], lit_len[j], lits[j]),
                  int(nc[j]), int(nl[j])) for j in range(nb)]

    def gathered(t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked (``t`` alone without a group)."""
        return t[None] if group is None else _all_gather(t[None], group, dev)

    pooled_c = np.concatenate(
        [a[1][:max(c - 1, 0)].astype(np.int64) - min_count
         for _, a, c, _ in local] or [np.zeros(0, np.int64)])
    pooled_l = np.concatenate(
        [a[2][:c].astype(np.int64) for _, a, c, _ in local]
        or [np.zeros(0, np.int64)])
    cn, cmax, cge = container.two_tier_stats(pooled_c)
    ln, lmax, lge = container.two_tier_stats(pooled_l)
    lcosts = container.litdict_costs([a[3][:l] for _, a, _, l in local])
    stats = torch.from_numpy(np.concatenate(
        [[cn, cmax], cge, [ln, lmax], lge, lcosts]).astype(np.int64))
    allstats = gathered(stats).numpy()
    stats = allstats.sum(axis=0)
    # the maxima combine as max, not sum
    stats[1] = allstats[:, 1].max()
    stats[36] = allstats[:, 36].max()
    cn, cmax, cge = int(stats[0]), int(stats[1]), stats[2:35]
    ln, lmax, lge = int(stats[35]), int(stats[36]), stats[37:70]
    lit_k = int(np.argmin(stats[70:77])) + 2
    widths = (container.widths_from_stats(cn, cmax, cge)
              + container.widths_from_stats(ln, lmax, lge))
    flat_cb = container._width_for(cmax)
    flat_lb = container._width_for(lmax)

    flat_parts, deep_parts, ld_parts = {}, {}, {}
    flat_sz = deep_sz = ld_sz = 0
    for b, (sym_b, cnt_b, ll_b, lits_b), nc, nl in local:
        fp = container.block_payload(sym_b, cnt_b, ll_b, lits_b, nc, nl,
                                     min_count, flat_cb, flat_lb)
        flat_parts[b] = fp
        flat_sz += len(fp[1])
        if deep:
            dp = container.block_payload_deep(sym_b, cnt_b, ll_b, lits_b,
                                              nc, nl, min_count, widths)
            deep_parts[b] = dp
            deep_sz += len(dp[1])
            lp = container.block_payload_deep(sym_b, cnt_b, ll_b, lits_b,
                                              nc, nl, min_count, widths,
                                              lit_k=lit_k)
            ld_parts[b] = lp
            ld_sz += len(lp[1])
    if not deep:
        return flat_parts, 0
    # the layout vote: summed sizes, so every rank picks the same winner
    votes = torch.tensor([flat_sz, deep_sz, ld_sz], dtype=torch.int64)
    fs, ds, ls = gathered(votes).sum(0).tolist()
    if deep is True:
        return ((ld_parts, container.FLAG_DEEP | container.FLAG_LITDICT)
                if ls < ds else (deep_parts, container.FLAG_DEEP))
    best = min((fs, ds, ls))
    if best == fs:
        return flat_parts, 0
    if best == ds:
        return deep_parts, container.FLAG_DEEP
    return ld_parts, container.FLAG_DEEP | container.FLAG_LITDICT


def _padded_blocks(arr: np.ndarray, block_size: int, k: int):
    """The stream's ``[nb, block_size]`` blocks and their lengths, the
    block count padded to a multiple of ``k`` with all-padding blocks of
    length 0 (as the JAX package pads to the mesh size)."""
    n = arr.size
    nb = -(-max(1, -(-n // block_size)) // k) * k
    x = np.zeros(nb * block_size, np.uint8)
    x[:n] = arr
    lens = np.clip(n - np.arange(nb) * block_size, 0,
                   block_size).astype(np.int32)
    return x.reshape(nb, block_size), lens


def _mesh_device(mesh: LocalMesh, device) -> None:
    """Raise ValueError unless ``device`` names the LocalMesh's devices
    (their type, or one of them): the mesh names where the work runs."""
    dev = torch.device(device)
    kind = mesh.devices[0].type
    if dev.type != kind or (dev.index is not None
                            and dev not in mesh.devices):
        raise ValueError(f"the LocalMesh names the devices "
                         f"{[str(d) for d in mesh.devices]}; device "
                         f"{str(dev)!r} is another")


def compress_distributed(data, mesh, *, device="cuda",
                         block_size: int = 1 << 16,
                         min_count: int = 6,
                         codec_index: int = 0) -> bytes:
    """Compress a byte stream to HRT1 with the block axis split over the
    mesh; the bytes equal the single-process ``api.compress``.  Width-1
    codecs only (no width transform), as in the JAX package.

    With a :class:`LocalMesh` the block count is padded to a multiple of
    the mesh size, each device encodes its contiguous share (hrt1_encode
    on a card), and the columns of every share come to the host, where
    ``container.serialize_blocks`` runs once, as the JAX single controller
    does.  The mesh names the devices: ``device`` must be their type (the
    default ``"cuda"`` for a mesh of cards) or one of them; any other
    raises ValueError.

    With a process group every rank passes the whole stream and gets the
    whole container back.  The block count is padded to a multiple of the
    world size and each rank encodes its contiguous share on ``device``.
    The all-padding blocks that fill the last share are dropped before
    :func:`serialize_local_blocks`, so they enter neither the width
    statistics nor the layout vote.  The parts are then all-gathered and
    assembled in block order."""
    w = api.hrt1_params(spec_mod.by_index(codec_index))[0]
    if w != 1:
        raise ValueError(f"compress_distributed encodes width-1 codecs; "
                         f"codec {codec_index} has {w}-byte symbols")
    arr = api._as_bytes_array(data)
    n = arr.size
    real_nb = max(1, -(-n // block_size))
    cap = planar.capacity_for(block_size, min_count)
    if isinstance(mesh, LocalMesh):
        _mesh_device(mesh, device)
        x, lens = _padded_blocks(arr, block_size, mesh.size)
        pbs = _encode_shares(x, lens, mesh, capacity=cap,
                             min_count=min_count)
        cols = [c[:real_nb] for c in _shares_to_host(pbs)]
        return container.serialize_blocks(codec_index, n, block_size,
                                          min_count, *cols)
    dev = _card(device)
    world, rank = tdist.get_world_size(mesh), tdist.get_rank(mesh)
    nbl = -(-real_nb // world)          # blocks per rank, padded count
    first = rank * nbl
    mine = arr[first * block_size:(first + nbl) * block_size]
    x = np.zeros(nbl * block_size, np.uint8)
    x[:mine.size] = mine
    lens = np.clip(n - (first + np.arange(nbl)) * block_size, 0,
                   block_size).astype(np.int32)
    tl = to_device(lens, dev)
    cols = encode_sup.encode_blocks_kernel(
        to_device(x.reshape(nbl, block_size), dev), tl, capacity=cap,
        min_count=min_count)
    n_real = min(max(real_nb - first, 0), nbl)
    pb = PlanarBlocks(*(c[:n_real] for c in (*cols, tl)))
    parts, flags = serialize_local_blocks(pb, min_count, mesh=mesh,
                                          first_block=first)
    gathered = _all_gather_objects((parts, flags), mesh, dev)
    if len({f for _, f in gathered}) != 1:
        raise RuntimeError(f"ranks chose different layouts: "
                           f"{[f for _, f in gathered]}")
    allparts = {}
    for p, _ in gathered:
        allparts.update(p)
    return container.assemble(codec_index, n, block_size,
                              [allparts[b] for b in range(real_nb)],
                              flags=flags)


def rank_card(rank: int, world_size: int, n_cards: int, *,
              local_rank: int | None = None,
              local_world_size: int | None = None) -> int:
    """The card an NCCL rank computes and exchanges on.

    Where the launcher names the rank's place on its host (``LOCAL_RANK``
    and ``LOCAL_WORLD_SIZE``, the ``torchrun`` convention, so several hosts
    work) the card is ``local_rank``; otherwise every rank is taken to be
    on this host and the card is ``rank % n_cards``.  Raises ValueError
    where two ranks of one host would share a card, which NCCL refuses."""
    if local_rank is None:
        card, ranks_here = rank % max(n_cards, 1), world_size
    else:
        card = local_rank
        ranks_here = (local_rank + 1 if local_world_size is None
                      else local_world_size)
    if not 0 <= card < n_cards or ranks_here > n_cards:
        raise ValueError(f"rank {rank}: {ranks_here} NCCL ranks on a host "
                         f"with {n_cards} card(s) would share a card")
    return card


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str = "nccl", store=None,
                         timeout: float = 60.0) -> None:
    """Join the process group as ``process_id`` of ``num_processes``, the
    counterpart of the JAX package's ``jax.distributed.initialize`` call.

    The processes meet at ``coordinator`` (``"host:port"``: a TCPStore that
    process 0 hosts), or through ``store`` (a ``torch.distributed`` Store:
    FileStore, TCPStore), or, with neither, where torchrun's environment
    says (``MASTER_ADDR`` / ``MASTER_PORT``; ``WORLD_SIZE`` / ``RANK`` stand
    in for a missing ``num_processes`` / ``process_id``).  With none of
    these the call does nothing, as the JAX call does in one process, and
    :func:`make_mesh` then gives the :class:`LocalMesh` of the visible cards.

    ``backend`` is 'nccl' (CUDA tensors; one card per rank: the rank's
    :func:`rank_card` becomes the current device before it joins) or
    'gloo' (CPU tensors, any compute device, the current device left as it
    is); it is taken as given.  The interconnect carries the size exchange,
    the statistics and vote, and the gathered container parts."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if coordinator is not None and store is not None:
        raise ValueError("give a coordinator or a store, not both")
    from_env = coordinator is None and store is None
    if from_env and not {"MASTER_ADDR", "MASTER_PORT"} <= set(os.environ):
        return
    world = (num_processes if num_processes is not None
             else _env_int("WORLD_SIZE"))
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("initialize_multihost needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK)")
    if backend == "nccl":
        if not (torch.cuda.is_available() and tdist.is_nccl_available()):
            raise RuntimeError("the nccl backend needs CUDA and a torch "
                               "built with NCCL")
        torch.cuda.set_device(rank_card(
            rank, world, torch.cuda.device_count(),
            local_rank=_env_int("LOCAL_RANK"),
            local_world_size=_env_int("LOCAL_WORLD_SIZE")))
    wait = datetime.timedelta(seconds=timeout)
    if coordinator is not None:
        host, _, port = coordinator.rpartition(":")
        store = tdist.TCPStore(host.strip("[]"), int(port), world, is_master=rank == 0,
                               timeout=wait)
    where = (dict(init_method="env://") if store is None
             else dict(store=store))
    tdist.init_process_group(backend, world_size=world, rank=rank,
                             timeout=wait, **where)
