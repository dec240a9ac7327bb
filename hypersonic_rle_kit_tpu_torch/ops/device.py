"""Plain torch encode/decode over planar blocks.

Torch port of hypersonic_rle_kit_tpu/ops/device.py (the XLA formulations),
batched over the block axis instead of vmapped.  ``decode_blocks`` is also
the plain version of the hrt1_decode kernel (ops/decode_sup.py).

- encode: neighbour-compare -> run boundaries -> distance to the next
  boundary by a reversed cumulative minimum -> emission mask -> prefix-sum
  compaction of commands and literals (``searchsorted``).
- decode: exclusive prefix sums of (lit_len + count) give each command's
  output start; ``searchsorted`` assigns commands to output positions; a
  gather-or-broadcast materializes the bytes.
"""

from __future__ import annotations

import torch

from .planar import PlanarBlocks

_I32 = torch.int32
_INT32_MAX = torch.iinfo(torch.int32).max


def encode_blocks(x: torch.Tensor, block_len: torch.Tensor, *, capacity: int,
                  min_count: int = 6,
                  only_sym: torch.Tensor | None = None) -> PlanarBlocks:
    """Encode ``[nb, B]`` uint8 blocks into planar commands.

    ``block_len[nb]`` gives the valid byte count of each block;
    ``only_sym[nb]`` (or None) restricts emission per block to runs of that
    byte (Single family).  Output columns equal planar.host_encode_block's
    (``lits`` is zero past ``n_lits``)."""
    nb, B = x.shape
    dev = x.device
    pos = torch.arange(B, dtype=_I32, device=dev)[None, :]
    n = block_len.to(device=dev, dtype=_I32)[:, None]
    valid = pos < n

    # pad with an alternating out-of-alphabet pattern so no run crosses n
    xi = torch.where(valid, x.to(_I32), 256 + (pos & 1))
    bnd = torch.ones((nb, B), dtype=torch.bool, device=dev)
    bnd[:, 1:] = xi[:, 1:] != xi[:, :-1]                 # run starts
    # next boundary strictly after i (reverse cumulative minimum)
    bnd_idx = torch.where(bnd, pos, B)
    nxt = torch.cat([bnd_idx[:, 1:],
                     torch.full((nb, 1), B, dtype=_I32, device=dev)], 1)
    next_bnd = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    run_len = torch.where(bnd, torch.minimum(next_bnd, n) - pos, 0)

    if only_sym is None:
        osym = torch.full((nb, 1), -1, dtype=_I32, device=dev)
    else:
        osym = only_sym.to(device=dev, dtype=_I32)[:, None]
    emit = (bnd & valid & (run_len >= min_count)
            & ((osym < 0) | (xi == osym)))
    emit_cum = torch.cumsum(emit.to(_I32), 1, dtype=_I32)
    n_runs = emit_cum[:, -1]
    if int(n_runs.max()) >= capacity:
        raise ValueError(f"{int(n_runs.max())} runs exceed capacity "
                         f"{capacity}")

    # command k -> its run-start position (B for padding slots)
    k = torch.arange(capacity, dtype=_I32, device=dev)[None, :]
    cmd_pos = torch.searchsorted(emit_cum, (k + 1).expand(nb, -1).contiguous(),
                                 side="left", out_int32=True)
    cmd_pos_c = cmd_pos.clamp(max=B - 1).long()
    real = k < n_runs[:, None]

    sym = torch.where(real, x.gather(1, cmd_pos_c), 0).to(torch.uint8)
    count = torch.where(real, run_len.gather(1, cmd_pos_c), 0)
    start = torch.where(real, cmd_pos, 0)
    end = start + count
    prev_end = torch.cat([torch.zeros((nb, 1), dtype=_I32, device=dev),
                          end[:, :-1]], 1)
    lit_len = torch.where(real, start - prev_end, 0)

    # tail command at index n_runs: trailing literals, count == 0
    last = (n_runs - 1).clamp(min=0).long()[:, None]
    last_end = torch.where(n_runs[:, None] > 0, end.gather(1, last), 0)
    lit_len.scatter_(1, n_runs.long()[:, None], n - last_end)
    n_cmds = n_runs + 1

    # literal compaction: bytes not covered by an emitted run
    cover_end = torch.cummax(torch.where(emit, pos + run_len, 0), dim=1).values
    lit_keep = valid & (pos >= cover_end)
    lit_cum = torch.cumsum(lit_keep.to(_I32), 1, dtype=_I32)
    n_lits = lit_cum[:, -1]
    lit_src = torch.searchsorted(lit_cum, (pos + 1).expand(nb, -1).contiguous(),
                                 side="left", out_int32=True)
    lits = torch.where(pos < n_lits[:, None],
                       x.gather(1, lit_src.clamp(max=B - 1).long()), 0
                       ).to(torch.uint8)
    return PlanarBlocks(sym, count.to(_I32), lit_len.to(_I32), lits,
                        n_cmds.to(_I32), n_lits.to(_I32), n[:, 0])


def decode_blocks(pb: PlanarBlocks) -> torch.Tensor:
    """Decode planar blocks back to ``[nb, B]`` uint8 (zero past block_len)."""
    nb, C = pb.sym.shape
    B = pb.lits.shape[1]
    dev = pb.sym.device
    count = pb.count.to(_I32)
    lit_len = pb.lit_len.to(_I32)
    c_idx = torch.arange(C, dtype=_I32, device=dev)[None, :]
    real = c_idx < pb.n_cmds.to(_I32)[:, None]

    span = torch.where(real, lit_len + count, 0)
    cum = torch.cumsum(span, 1, dtype=_I32)
    starts = torch.where(real, cum - span, _INT32_MAX)
    ll_real = torch.where(real, lit_len, 0)
    cum_lit = torch.cumsum(ll_real, 1, dtype=_I32) - ll_real

    j = torch.arange(B, dtype=_I32, device=dev)[None, :].expand(nb, -1)
    c = torch.searchsorted(starts, j.contiguous(), right=True,
                           out_int32=True) - 1
    c = c.clamp(0, C - 1).long()
    within = j - starts.gather(1, c)
    is_lit = within < lit_len.gather(1, c)
    lit_idx = (cum_lit.gather(1, c) + within).clamp(0, B - 1).long()
    out = torch.where(is_lit, pb.lits.gather(1, lit_idx), pb.sym.gather(1, c))
    return torch.where(j < pb.block_len.to(_I32)[:, None], out, 0
                       ).to(torch.uint8)
