"""Multi-device / multi-host distribution of the block codec.

Port of hypersonic_rle_kit_tpu/parallel/dist.py onto ``torch.distributed``.
A mesh is a process group: one rank per device, each holding its own
contiguous slice of the block axis on its own device.  The JAX package's
``shard_map`` bodies become the code every rank runs on its slice:

- each rank encodes its blocks (``encode_sup.encode_blocks_kernel``: the
  hrt1_encode kernel on CUDA) and decodes them
  (``decode_sup.decode_columns_device``: hrt1_decode);
- the per-block compressed sizes are exchanged with one ``all_gather``,
  and an exclusive prefix sum over them gives every block's byte offset in
  the final container;
- a multi-host serialization exchanges only summable width statistics and
  a three-way layout vote (a few hundred bytes per rank), so every rank
  picks the same widths and layout and the assembled container equals the
  single-process ``api.compress`` bytes.

Collectives run on the backend's device, and the small size and statistics
vectors move there in one explicit step: NCCL exchanges CUDA tensors (a
rank whose data is on the CPU cannot use it), gloo exchanges CPU tensors
(whatever device the rank computes on).  Under NCCL each rank of a host has
a card of its own (:func:`rank_card`), made the current device when it
joins, so a bare ``"cuda"`` is that card.  Nothing switches backend or
device behind the caller's back.

Tests run ranks as CPU processes on gloo (``tests/test_torch_dist.py``).
"""

from __future__ import annotations

import contextlib
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
# powers of two 2^0 .. 2^30: the bit width of a non-negative int32 is the
# number of them it reaches
_POW2 = tuple(1 << k for k in range(31))


def make_mesh(n_devices: int | None = None):
    """The world group, or a group of its first ``n_devices`` ranks.

    Creating a sub-group is a collective: every rank of the world calls
    this; ranks outside the group get ``GroupMember.NON_GROUP_MEMBER``."""
    world = tdist.get_world_size()
    if n_devices is None or n_devices == world:
        return tdist.group.WORLD
    if not 1 <= n_devices <= world:
        raise ValueError(f"n_devices {n_devices} outside [1, {world}]")
    return tdist.new_group(list(range(n_devices)))


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
    exact: a float log2 rounds wrong next to powers of two."""
    pow2 = torch.tensor(_POW2, dtype=_I32, device=v.device)
    return torch.searchsorted(pow2, v.to(_I32).contiguous(), right=True,
                              out_int32=True)


def _encode_local(x, block_len, *, capacity: int, min_count: int):
    """Encode this rank's ``[nb, B]`` blocks; returns the planar blocks and
    each block's serialized payload size in the flat layout (bit-packed
    counts and lit_lens at the block's own widths, run symbols, literals)."""
    pb = PlanarBlocks(*encode_sup.encode_blocks_kernel(
        x, block_len, capacity=capacity, min_count=min_count), block_len)
    n_runs = pb.n_cmds - 1
    cnt_w = _bit_width((pb.count.amax(1) - min_count).clamp(min=0))
    lit_w = _bit_width(pb.lit_len.amax(1))
    size = ((cnt_w * n_runs + 7) // 8 + (lit_w * pb.n_cmds + 7) // 8
            + n_runs + pb.n_lits)
    return pb, size


def _exchange_sizes(size: torch.Tensor, mesh):
    """All ranks' per-block sizes (the only collective of the encode step)
    and their exclusive prefix sum, the global byte offsets (int64)."""
    all_sizes = _all_gather(size, mesh, size.device)
    offsets = torch.cumsum(all_sizes, 0, dtype=torch.int64) - all_sizes
    return all_sizes, offsets


def pipeline_step(x, block_len, *, capacity: int, min_count: int, mesh):
    """One compress -> size-exchange -> decompress step over the mesh.

    ``x: [nb, B] uint8`` and ``block_len: [nb] int32`` are this rank's
    slice of the block axis (the same ``nb`` on every rank), on its device.
    Returns ``(decoded blocks, this slice's global byte offsets, this
    slice's compressed sizes)``."""
    pb, size = _encode_local(x, block_len, capacity=capacity,
                             min_count=min_count)
    _, offsets = _exchange_sizes(size, mesh)
    y = decode_sup.decode_columns_device(
        pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits,
        pb.block_len, block_size=x.shape[1])
    nb = x.shape[0]
    first = tdist.get_rank(mesh) * nb
    return y, offsets[first:first + nb], size


def encode_sharded(x, block_len, *, capacity: int, min_count: int, mesh):
    """Encode with a sizes-only exchange.

    Each rank encodes its slice and **keeps its planar columns**; only the
    per-block serialized sizes (4 bytes per block) cross the interconnect,
    and every rank derives the global offset table from them: O(n_blocks)
    metadata moves, never the O(stream) column data.  Returns (this rank's
    PlanarBlocks, all sizes, all offsets), the two tables the same on every
    rank."""
    pb, size = _encode_local(x, block_len, capacity=capacity,
                             min_count=min_count)
    all_sizes, offsets = _exchange_sizes(size, mesh)
    return pb, all_sizes, offsets


def serialize_local_blocks(pb: PlanarBlocks, mesh, *, min_count: int = 6,
                           deep: bool | str = "auto",
                           first_block: int | None = None
                           ) -> tuple[dict[int, tuple], int]:
    """Serialize only this rank's blocks.

    ``pb`` holds this rank's blocks, the first of which is block
    ``first_block`` of the stream (default: rank x the local block count).
    Returns ``({block_index: (table_entry, payload_bytes)}, flags)``; the
    parts of all ranks put in block order by :func:`container.assemble`
    (with the same ``flags``) equal the single-process ``api.compress``
    bytes.  What crosses the mesh is the summable width statistics
    (``container.two_tier_stats``, 77 int64 per rank) and, for the deep
    layouts, a three-way size vote (3 int64): every rank picks the same
    container-uniform widths and the same flat / deep / litdict layout."""
    dev = pb.sym.device
    nb = pb.sym.shape[0]
    if first_block is None:
        first_block = tdist.get_rank(mesh) * nb
    local = []                          # (block_index, arrays, nc, nl)
    if nb:
        sym, count, lit_len, lits, nc, nl = api._columns_to_host(
            pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)
        local = [(first_block + j, (sym[j], count[j], lit_len[j], lits[j]),
                  int(nc[j]), int(nl[j])) for j in range(nb)]

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
    allstats = _all_gather(stats[None], mesh, dev).numpy()
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
    votes = torch.tensor([[flat_sz, deep_sz, ld_sz]], dtype=torch.int64)
    fs, ds, ls = _all_gather(votes, mesh, dev).sum(0).tolist()
    if deep is True:
        return ((ld_parts, container.FLAG_DEEP | container.FLAG_LITDICT)
                if ls < ds else (deep_parts, container.FLAG_DEEP))
    best = min((fs, ds, ls))
    if best == fs:
        return flat_parts, 0
    if best == ds:
        return deep_parts, container.FLAG_DEEP
    return ld_parts, container.FLAG_DEEP | container.FLAG_LITDICT


def compress_distributed(data, mesh, *, device="cuda",
                         block_size: int = 1 << 16,
                         min_count: int = 6,
                         codec_index: int = 0) -> bytes:
    """Compress a byte stream to HRT1 with the block axis split over the
    mesh's ranks; every rank passes the whole stream and gets the whole
    container back, byte-equal to the single-process ``api.compress``.

    The block count is padded to a multiple of the world size and each
    rank encodes its contiguous share on ``device`` (hrt1_encode on CUDA).
    The all-padding blocks that fill the last share are dropped before
    :func:`serialize_local_blocks`, so they enter neither the width
    statistics nor the layout vote.  The parts are then all-gathered and
    assembled in block order.  Width-1 codecs only (no width transform),
    as in the JAX package."""
    w = api.hrt1_params(spec_mod.by_index(codec_index))[0]
    if w != 1:
        raise ValueError(f"compress_distributed encodes width-1 codecs; "
                         f"codec {codec_index} has {w}-byte symbols")
    arr = api._as_bytes_array(data)
    n = arr.size
    dev = _card(device)
    world, rank = tdist.get_world_size(mesh), tdist.get_rank(mesh)
    real_nb = max(1, -(-n // block_size))
    nbl = -(-real_nb // world)          # blocks per rank, padded count
    first = rank * nbl
    mine = arr[first * block_size:(first + nbl) * block_size]
    x = np.zeros(nbl * block_size, np.uint8)
    x[:mine.size] = mine
    lens = np.clip(n - (first + np.arange(nbl)) * block_size, 0,
                   block_size).astype(np.int32)
    tl = to_device(lens, dev)
    cols = encode_sup.encode_blocks_kernel(
        to_device(x.reshape(nbl, block_size), dev), tl,
        capacity=planar.capacity_for(block_size, min_count),
        min_count=min_count)
    n_real = min(max(real_nb - first, 0), nbl)
    pb = PlanarBlocks(*(c[:n_real] for c in (*cols, tl)))
    parts, flags = serialize_local_blocks(pb, mesh, min_count=min_count,
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


def initialize_multihost(store, world_size: int, rank: int, *, backend: str,
                         timeout: float = 60.0) -> None:
    """Join the process group through ``store`` (a ``torch.distributed``
    Store: FileStore, TCPStore) as ``rank`` of ``world_size``.

    ``backend`` is 'nccl' (CUDA tensors; one card per rank: the rank's
    :func:`rank_card` becomes the current device before it joins) or
    'gloo' (CPU tensors, any compute device, the current device left as it
    is); it is taken as given.  The interconnect carries the size exchange,
    the statistics and vote, and the gathered container parts."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl":
        if not (torch.cuda.is_available() and tdist.is_nccl_available()):
            raise RuntimeError("the nccl backend needs CUDA and a torch "
                               "built with NCCL")
        torch.cuda.set_device(rank_card(
            rank, world_size, torch.cuda.device_count(),
            local_rank=_env_int("LOCAL_RANK"),
            local_world_size=_env_int("LOCAL_WORLD_SIZE")))
    tdist.init_process_group(backend, store=store, world_size=world_size,
                             rank=rank,
                             timeout=datetime.timedelta(seconds=timeout))
