#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (needs a Hopper card).

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. card: torch must see a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles the Hopper kernels from csrc/*.cu with nvcc, one
   process per source, all started together, into the codec's library
   and the word microbenchmark's.
3. kernels vs plain: hrt1_decode on synthetic columns (dense, sparse,
   all-literal, whole-block run, ragged tail, zero-count commands mid-stream,
   min_count 1, runs across every 16 KiB tile edge with block_len ending
   mid-tile; 4 KiB, 20011 B, 20012 B, 64 KiB and 256 KiB blocks: B % 16 !=
   0 and W % 4 != 0 take the unvectorised paths), hrt1_unpack_resolve on
   the packed sections of the 64 MiB DCT corpus's deep and flat containers,
   of the deep one with tampered stored escape counts (its bad flags set
   and equal) and of random bytes with hostile n_cmds at every width and
   several capacities, and hrt1_encode on synthetic blocks
   (the same edges plus Single, min_count 4; 4 KiB, 20011 B, 64 KiB,
   192 KiB and 256 KiB blocks); a 4 MiB one-block stream through both; a
   capacity of exactly the commands (padding by the tail tile), one less
   raising.  Each byte-equal to its plain torch version on the same card
   tensors.  The section-level decoders (decode_deep_device on the deep
   sections, decode_payload_device on the flat ones, the JAX package's
   argument lists) equal dispatch_packed and the plain versions.
4. main paths.  Compress: api.compress(backend="kernel", device="cuda") on
   the 64 MiB DCT corpus ("8 Bit" and "8 Bit Single"), the random and bwt
   rows, "32 Bit (Symbol)" and "24 Bit (Symbol)" on 16 MiB + 1001 bytes
   must equal backend="native" byte for byte, and hrt1_encode's launch
   counter must move.  Decompress: api.decompress(device="cuda") of those
   blobs and of the 64 MiB corpus's flat layout must equal the input, and
   both decode kernels' launch counters must move.  Each path's counters
   are set to 0 just before it and read just after.
5. times: the device time of one call of each kernel (CUDA-graph
   replays, no host work) and its bound, beside CUDA-event medians of its
   plain version and of the wrappers; dispatch_packed on shipped sections
   (deep and flat) as device time, by CUDA events and with its plain
   version, and its device operations per call (nodes of a captured CUDA
   graph: at most 4), and the two section decoders as device time;
   the wall time of one whole decompress (64 MiB DCT, and the 32-bit width
   row with the device re-interleave); the compress wall of the 64 MiB DCT
   corpus split into its stages.
6. K4: word_slice_sum and word_sampled_prefix on the word microbenchmark's
   [256, 2048, 128] bf16 plane (their main path, counted), each equal to
   every plain formulation of its function (the five Pallas bodies of
   scripts/micro_word.py), and all seven timed beside one PyTorch call of
   each function (torch.sum over the row groups; torch.matmul with the
   taps [4, 3, 2, 1]).
7. reference streams: decompress_ref_device on the card of "8 Bit" on
   32 MiB of the DCT corpus and of one codec per family and width on
   16 MiB + 13 B, each equal to its input and decoded by hrt1_decode
   alone; then each row in the stages the entry point runs (host walk |
   H2D | kernel | re-interleave | D2H), with hrt1_decode held against its
   plain version on the row's device columns.
8. Low Entropy (+Short) of 4 MiB and an rle8m container of 32
   subsections, decoded on the card, equal to the input; the same stage
   split and plain comparison; the Python walker's share of each wall.
9. MMTF: mmtf_scan equal to its plain version on [8, 4096] and at the
   chunk edges of its kernel (no units, one unit, C - 1 / C / C + 1 and
   2C - 1 / 2C / 2C + 1 units, several blocks; 16 and 32 lanes, both
   ways); mmtf_transform of 1 MiB + 11 B (its main path, counted) equal
   to formats.mmtf and round-tripping, and its four scans equal to the
   plain version at their shapes; Bit-MMTF 8 / 16 on 16 MiB; mmtf_scan's
   device time on 1 MiB of DCT and 1 MiB of uniform bytes (16 lanes, one
   block, encode and decode) beside its plain version.
10. distribution: (a) two gloo ranks, fresh interpreters sharing the card,
    run parallel/dist.compress_distributed on the 64 MiB DCT corpus
    (256 KiB blocks), whose bytes must equal the native container, and
    pipeline_step on the same blocks, which must return them; each rank
    must have launched hrt1_encode and hrt1_decode, and then holds both
    against their plain versions on its blocks.  (b) one NCCL rank in
    this process (world size 1) compresses 16 MiB the same way, so the
    exchange runs on CUDA tensors once.  Logs the two-rank wall beside the
    single-process compress wall.  (c) with two cards or more: NCCL at
    world size min(4, cards), one rank per card (fresh interpreters that
    join by coordinator address, initialize_multihost(coordinator=...)), on
    make_dataset(64 * world) (weak scaling) and the 64 MiB corpus (strong
    scaling), 256 KiB blocks: every rank's compress_distributed at its
    default device must equal the native container, which decompresses
    to the input on card 0; each rank's pipeline_step returns its blocks
    with exclusive-prefix offsets; each rank launched hrt1_encode and
    hrt1_decode and holds both against their plain versions on its
    blocks; every collective ran on the rank's own card.  Logs the wall
    (slowest rank, best of 2 after a warm-up) at world 1 and at world N,
    each rank's split (encode with its D2H and local statistics |
    statistics and vote exchange | serialize | parts gather | assemble)
    and the bytes each collective sent.  With four cards the 64 MiB run
    again as two emulated hosts of two cards (ranks 0-1 see the first two
    cards, ranks 2-3 the next two, each with LOCAL_RANK and
    LOCAL_WORLD_SIZE 2: rank_card's LOCAL_RANK path).  Then
    dryrun_multichip on NCCL, and its refusal of more ranks than cards.
    (d) one process, every card (never skipped: 1 card, or all visible):
    make_mesh() with no group is the LocalMesh of the visible cards;
    compress_distributed of the 64 MiB corpus on it equals the native
    container (sha256) and launches hrt1_encode once a card; pipeline_step
    on its blocks returns them on card 0 with exclusive-prefix offsets and
    launches hrt1_encode and hrt1_decode once a card; both kernels equal
    their plain versions on every card's share.  Logs the wall (best of 2
    after a warm-up) on 1 card and on all, split (encode on all cards |
    D2H | serialize), beside api.compress's and (c)'s.
11. device fuzz lane: fuzz.run_device on the card over 20 inputs (10
    random, 10 iterative) x the 10 DEVICE_FUZZ_CODECS: round trips, 4
    mutated and 3 truncated containers each; no failure, and hrt1_decode
    and hrt1_unpack_resolve must have launched.
12. bench: the port's harness (hypersonic_rle_kit_tpu_torch/bench.py) in
    this process at its defaults (64 MiB DCT corpus, 256 KiB blocks, 8
    iterations): every row checks its round trip and raises on a
    mismatch; ok must be true and every *_gbps > 0.  Its JSON object is
    printed on a line of its own before the kernels line.

The line before the last is one JSON object with each kernel's route,
source, replaced TPU kernel, launches, max |error|, times (the kernel's
device time; CUDA-event times of its plain version and of one PyTorch call
where there is one), and its bound from
this run's inputs (bytes each read or written once at 3.35 TB/s, or
operations at 67 TFLOP/s, the larger); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hypersonic_rle_kit_tpu_torch import (api, bench, datasets, fuzz,
                                          graft_entry, spec)
from hypersonic_rle_kit_tpu_torch.bench import (best_wall, card_line,
                                                compress_split)
from hypersonic_rle_kit_tpu_torch.formats import low_entropy, mmtf, registry
from hypersonic_rle_kit_tpu_torch.ops import (_kernels, decode_sup, device,
                                              encode_sup, low_entropy_device,
                                              micro_word, mmtf_device, planar,
                                              ref_device, transfer,
                                              unpack_device)
from hypersonic_rle_kit_tpu_torch.parallel import container, dist
from hypersonic_rle_kit_tpu_torch.utils import native
from hypersonic_rle_kit_tpu_torch.utils.cuda_timing import (
    cuda_ms, graph_ms, graph_ops)

MIB = 1 << 20
TILE = 16384            # the encode and decode kernels' tile bytes
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12
KERNELS = {
    "hrt1_decode": dict(
        route="cuda", source="hypersonic_rle_kit_tpu_torch/csrc/hrt1_decode.cu",
        replaces="hypersonic_rle_kit_tpu/ops/decode_sup.py:631"),
    "hrt1_unpack_resolve": dict(
        route="cuda",
        source="hypersonic_rle_kit_tpu_torch/csrc/hrt1_unpack_resolve.cu",
        replaces="hypersonic_rle_kit_tpu/ops/unpack_device.py:208"),
    "hrt1_encode": dict(
        route="cuda",
        source="hypersonic_rle_kit_tpu_torch/csrc/hrt1_encode.cu",
        replaces="hypersonic_rle_kit_tpu/ops/encode_sup.py:298"),
    "word_slice_sum": dict(
        route="cuda", source="hypersonic_rle_kit_tpu_torch/csrc/micro_word.cu",
        replaces="scripts/micro_word.py:72"),
    "word_sampled_prefix": dict(
        route="cuda", source="hypersonic_rle_kit_tpu_torch/csrc/micro_word.cu",
        replaces="scripts/micro_word.py:72"),
    "mmtf_scan": dict(
        route="cuda", source="hypersonic_rle_kit_tpu_torch/csrc/mmtf.cu",
        replaces="hypersonic_rle_kit_tpu/ops/mmtf_device.py:62"),
}
# ref_device rows: one codec per family and width
REF_CODECS = ("8 Bit Packed", "8 Bit Single Short", "16 Bit Packed (Symbol)",
              "24 Bit (Symbol)", "64 Bit 3LUT (Symbol)",
              "32 Bit 1LUT Short (Symbol)", "128 Bit Packed (Byte)")
REF_MIB = 16            # host encoders take 1-5 s per codec at this size


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes each read or written
    once over HBM, or the operations over the float32 rate, the larger."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def unpack_bytes(args, kw, outs) -> int:
    """Bytes hrt1_unpack_resolve must move: its arguments read once, but of
    the overflow and miss rows (pack_for_device sizes them for ``capacity``
    values, zero past each block's stored population) only the values the
    stored populations hold, and its outputs written once."""
    ovf = {"cnt_ovf_raw": ("n_cnt_ovf", kw.get("cnt_ovf_bits", 0)),
           "ll_ovf_raw": ("n_ll_ovf", kw.get("ll_ovf_bits", 0)),
           "miss_raw": ("n_miss", 8)}
    n = nbytes(*args, *outs, *(v for k, v in kw.items() if k not in ovf))
    for row, (pop, bits) in ovf.items():
        if kw.get(row) is None:
            continue
        if kw.get(pop) is None:
            n += nbytes(kw[row])
        else:
            vals = kw[pop].long().clamp(0, kw["capacity"])
            n += int(((vals * bits + 7) // 8).sum())
    return n


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phase 3 inputs
# ---------------------------------------------------------------------------

def synthetic_blocks(kind: str, B: int, nb: int, seed: int):
    """[nb, B] input blocks of one edge case, numpy: (x, block_len,
    only_sym or None, min_count); x is zero past each block's length."""
    rng = np.random.default_rng(seed)
    lens = np.full(nb, B, np.int32)
    only_sym, min_count = None, 6
    if kind == "dense":
        x = np.repeat(rng.integers(0, 251, (nb, B // 6 + 1)), 6,
                      axis=1)[:, :B].astype(np.uint8)
    elif kind in ("sparse", "ragged_tail", "single", "min_count_4"):
        x = datasets.make_dataset(-(-nb * B // MIB), seed=seed)
        x = x[:nb * B].reshape(nb, B).copy()
        if kind == "ragged_tail":
            lens[-3:] = [B - 777, 17, 0]
        elif kind == "single":
            # a long run of another byte must become literals
            x[:, B // 4:B // 2] = 9
            only_sym = np.resize(np.array([0, 9, 3, -1], np.int32), nb)
        elif kind == "min_count_4":
            min_count = 4
    elif kind == "all_literal":
        x = rng.integers(0, 256, (nb, B), dtype=np.uint8)
    elif kind == "whole_run":
        x = np.repeat(rng.integers(0, 256, (nb, 1), dtype=np.uint8), B, 1)
    elif kind == "min_count_1":
        x = rng.integers(0, 2, (nb, B), dtype=np.uint8)
        min_count = 1
    elif kind == "tile_spanning":
        # literals with runs across every 16 KiB boundary of the encode
        # tiles and 16 KiB output tiles of the decode: 1..12 bytes on each
        # side (emitted or not at min_count 6), and one run over 2+ tiles
        x = rng.integers(0, 256, (nb, B), dtype=np.uint8)
        for b in range(nb):
            for k, edge in enumerate(range(TILE, B, TILE)):
                lo, hi = int(rng.integers(1, 13)), int(rng.integers(1, 13))
                x[b, edge - lo:edge + hi] = (b + k) % 251
            if B > 3 * TILE:
                x[b, TILE - 5:3 * TILE + 7] = 0
        # block_len ending mid-tile
        lens[:] = [B - (b * 4099) % min(TILE, B) for b in range(nb)]
    else:
        raise ValueError(kind)
    for b in range(nb):
        x[b, lens[b]:] = 0
    return x, lens, only_sym, min_count


def synthetic_columns(kind: str, B: int, nb: int, seed: int):
    """Planar columns of one edge case, numpy, lits trimmed to int32 words
    the way container.pack_for_device trims them."""
    if kind == "zero_count_mid":
        rng = np.random.default_rng(seed)
        C = 1024
        sym = rng.integers(0, 256, (nb, C), dtype=np.uint8)
        count = np.where(rng.random((nb, C)) < 0.3, 0,
                         rng.integers(1, 60, (nb, C))).astype(np.int32)
        lit_len = rng.integers(0, 16, (nb, C)).astype(np.int32)
        n_cmds = rng.integers(C // 2, C, nb).astype(np.int32)
        for b in range(nb):
            count[b, n_cmds[b] - 1:] = 0
            lit_len[b, n_cmds[b]:] = 0
        lens = np.minimum((count + lit_len).sum(1), B).astype(np.int32)
        n_lits = lit_len.sum(1).astype(np.int32)
        lits = rng.integers(0, 256, (nb, B), dtype=np.uint8)
        cols = [sym, count, lit_len, lits, n_cmds, n_lits]
    else:
        x, lens, _, min_count = synthetic_blocks(kind, B, nb, seed)
        cap = planar.capacity_for(B, min_count)
        cols = list(native.planar_from_bytes(x, lens, cap, min_count))
    lw = min(max(128, -(-int(cols[5].max()) // 128) * 128), B)
    lits = np.ascontiguousarray(cols[3][:, :lw])
    cols[3] = decode_sup.lits_to_words(lits) if lw % 4 == 0 else lits
    return cols + [lens]


def check_decode_cases(dev) -> int:
    worst = 0
    kinds = ("dense", "sparse", "all_literal", "whole_run", "ragged_tail",
             "zero_count_mid", "min_count_1", "tile_spanning")
    # 20011 and 20012: B % 16 != 0, the bytes form and words with
    # W % 4 != 0 (the unvectorised stores)
    for B in (4096, 20011, 20012, 65536, 262144):
        for i, kind in enumerate(kinds):
            cols = synthetic_columns(kind, B, 8, seed=i + 1)
            t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in cols]
            for words in (True, False) if B % 4 == 0 else (False,):
                k = decode_sup.decode_columns_device(*t, block_size=B,
                                                     out_words=words)
                p = decode_sup.decode_columns_plain(*t, block_size=B,
                                                    out_words=words)
                torch.cuda.synchronize()
                err = max_abs_err(k, p)
                if err:
                    raise AssertionError(f"hrt1_decode != plain: {kind} "
                                         f"B={B} words={words} err={err}")
                worst = max(worst, err)
            log(f"  hrt1_decode == plain: {kind:14s} B={B}")
    return worst


def check_encode_cases(dev) -> int:
    worst = 0
    kinds = ("dense", "sparse", "all_literal", "whole_run", "ragged_tail",
             "single", "min_count_1", "min_count_4", "tile_spanning")
    # 20011: B % 16 != 0 (tiles copied by the threads, not by TMA)
    for B in (4096, 20011, 65536, 196608, 262144):
        for i, kind in enumerate(kinds):
            x, lens, only_sym, mc = synthetic_blocks(kind, B, 8, seed=i + 1)
            if kind == "min_count_1":
                x[0] = np.arange(B) % 2        # n_cmds = B + 1, near capacity
            t = [None if a is None else torch.from_numpy(a).to(dev)
                 for a in (x, lens, only_sym)]
            kw = dict(capacity=planar.capacity_for(B, mc), min_count=mc,
                      only_sym=t[2])
            k = encode_sup.encode_blocks_kernel(t[0], t[1], **kw)
            pb = device.encode_blocks(t[0], t[1], **kw)
            p = (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(k, p))
            if err:
                raise AssertionError(f"hrt1_encode != plain: {kind} B={B} "
                                     f"err={err}")
            worst = max(worst, err)
        log(f"  hrt1_encode == plain: {len(kinds)} kinds at B={B}")
    return worst


def check_extremes(dev) -> tuple[int, int]:
    """A 4 MiB one-block stream through both kernels; a capacity of exactly
    the blocks' command count (its padding written by the tail tile); one
    slot less must raise.  Returns the worst errors (encode, decode)."""
    x = torch.from_numpy(datasets.make_dataset(4)[None].copy()).to(dev)
    B = x.shape[1]
    tl = torch.tensor([B], dtype=torch.int32, device=dev)
    kw = dict(capacity=planar.capacity_for(B, 6), min_count=6)
    k = encode_sup.encode_blocks_kernel(x, tl, **kw)
    pb = device.encode_blocks(x, tl, **kw)
    e_enc = max(max_abs_err(a, b) for a, b in zip(k, (
        pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)))
    e_dec = max_abs_err(decode_sup.decode_columns_device(*k, tl, block_size=B),
                        decode_sup.decode_columns_plain(*k, tl, block_size=B))
    if e_enc or e_dec:
        raise AssertionError(f"4 MiB one block: hrt1_encode err {e_enc}, "
                             f"hrt1_decode err {e_dec}")
    log(f"  hrt1_encode, hrt1_decode == plain: one 4 MiB block "
        f"({int(k[4][0])} commands)")
    x, lens, _, _ = synthetic_blocks("sparse", 65536, 8, seed=3)
    xd, ld = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    tight = int(device.encode_blocks(xd, ld, capacity=planar.capacity_for(
        65536, 6)).n_cmds.max())
    k = encode_sup.encode_blocks_kernel(xd, ld, capacity=tight)
    pb = device.encode_blocks(xd, ld, capacity=tight)
    e = max(max_abs_err(a, b) for a, b in zip(k, (
        pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)))
    if e:
        raise AssertionError(f"hrt1_encode != plain at capacity {tight}")
    try:
        encode_sup.encode_blocks_kernel(xd, ld, capacity=tight - 1)
    except ValueError:
        pass
    else:
        raise AssertionError("hrt1_encode took a block over capacity")
    log(f"  hrt1_encode == plain at the tight capacity {tight}; "
        f"{tight - 1} raises")
    return max(e_enc, e), e_dec


def plain_dispatch(pk: dict, arrs: dict):
    """dispatch_packed with each kernel replaced by its plain version."""
    args, kw = unpack_device.section_args(pk, arrs)
    count, lit_len, sym, _ = unpack_device.unpack_resolve_plain(*args, **kw)
    return decode_sup.decode_columns_plain(
        arrs["syms"] if sym is None else sym, count, lit_len, arrs["lits"],
        arrs["n_cmds"], arrs["n_lits"], arrs["block_len"],
        block_size=pk["info"].block_size, out_words=True)


def section_decode(pk: dict, arrs: dict):
    """The pack's sections through the section-level decoder of its layout,
    called with the JAX package's argument lists: decode_deep_device
    (returns the words and the bad flags) or decode_payload_device (bad
    None); int32 words."""
    info = pk["info"]
    kw = dict(cnt_bits=pk["cnt_bits"], lit_bits=pk["lit_bits"],
              capacity=pk["capacity"], block_size=info.block_size,
              min_count=info.min_count, out_words=True)
    if info.deep:
        return unpack_device.decode_deep_device(
            *(arrs[k] for k in ("cnts_raw", "cnt_ovf_raw", "lls_raw",
                                "ll_ovf_raw", "lut_raw", "miss_raw", "dict7",
                                "lits", "n_cmds", "n_lits", "block_len",
                                "n_cnt_ovf", "n_ll_ovf", "n_miss")),
            cnt_ovf_bits=pk["cnt_ovf_bits"], ll_ovf_bits=pk["ll_ovf_bits"],
            **kw)
    return unpack_device.decode_payload_device(
        *(arrs[k] for k in ("cnts_raw", "lls_raw", "syms", "lits", "n_cmds",
                            "n_lits", "block_len")), **kw), None


def random_sections(widths, cap: int, seed: int, dev, nb: int = 5):
    """unpack_resolve's arguments on random packed bytes of the given
    (count, lit_len, count overflow, lit_len overflow) widths, rows 4 bytes
    past their last value (off 16-byte boundaries), n_cmds -1, 0, 1, cap
    and 2 cap, random stored escape counts."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def sec(w):
        return t(rng.integers(0, 256, (nb, (w * cap + 7) // 8 + 4),
                              dtype=np.uint8))

    cb, lb, cob, lob = widths
    args = (sec(cb), sec(lb),
            t(np.resize(np.array([-1, 0, 1, cap, 2 * cap], np.int32), nb)))
    kw = dict(cnt_ovf_raw=sec(cob), ll_ovf_raw=sec(lob), lut_raw=sec(3),
              miss_raw=t(rng.integers(0, 256, (nb, cap), dtype=np.uint8)),
              dict7=t(rng.integers(0, 256, (nb, 7), dtype=np.uint8)),
              **{k: t(rng.integers(0, 40, nb, dtype=np.int32))
                 for k in ("n_cnt_ovf", "n_ll_ovf", "n_miss")},
              cnt_bits=cb, lit_bits=lb, cnt_ovf_bits=cob, ll_ovf_bits=lob,
              capacity=cap, min_count=6)
    return args, kw


def unpack_err(args, kw) -> int:
    """hrt1_unpack_resolve against its plain version: max |error| over
    count, lit_len, sym and bad."""
    k = unpack_device.unpack_resolve(*args, **kw)
    p = unpack_device.unpack_resolve_plain(*args, **kw)
    torch.cuda.synchronize()
    if [x is None for x in k] != [y is None for y in p]:
        raise AssertionError("hrt1_unpack_resolve and its plain version "
                             "return different outputs")
    return max(max_abs_err(x, y) for x, y in zip(k, p) if x is not None)


def check_unpack_cases(dev, packs: dict) -> int:
    """hrt1_unpack_resolve == plain on the main path's sections (name ->
    (pack, shipped sections)), a tampered copy of the deep ones and random
    bytes with hostile n_cmds; returns the worst error."""
    worst = 0
    for name, (pk, arrs) in packs.items():
        worst = max(worst, unpack_err(*unpack_device.section_args(pk, arrs)))
        if worst:
            raise AssertionError(f"hrt1_unpack_resolve != plain: {name} "
                                 f"err={worst}")
        log(f"  hrt1_unpack_resolve == plain on the {name} sections "
            f"({pk['info'].n_blocks} blocks, cap {pk['capacity']})")
    args, kw = unpack_device.section_args(*packs["dct64"])
    kw = {**kw, **{k: kw[k].clone() for k in ("n_cnt_ovf", "n_ll_ovf",
                                               "n_miss")}}
    kw["n_cnt_ovf"][1] += 1
    kw["n_ll_ovf"][100] -= 1
    kw["n_miss"][200] += 1
    err = unpack_err(args, kw)
    bad = unpack_device.unpack_resolve(*args, **kw)[3].nonzero().flatten()
    if err or bad.tolist() != [1, 100, 200]:
        raise AssertionError(f"tampered dct64: err={err}, bad blocks "
                             f"{bad.tolist()} (want [1, 100, 200])")
    log("  hrt1_unpack_resolve == plain on the dct64 sections with tampered "
        "stored counts; bad set on blocks [1, 100, 200] alone")
    widths = ((0, 1, 7, 8), (1, 7, 8, 25), (7, 8, 25, 0), (8, 25, 0, 1),
              (25, 0, 1, 7), (6, 4, 8, 8))
    for cap in (8, 4096, 40000, 43776):
        for w in widths:
            args, kw = random_sections(w, cap, cap + sum(w), dev)
            flat = {k: kw[k] for k in ("cnt_bits", "lit_bits", "capacity",
                                       "min_count")}
            err = max(unpack_err(args, kw), unpack_err(args, flat))
            if err:
                raise AssertionError(f"hrt1_unpack_resolve != plain on "
                                     f"random bytes: widths {w} cap {cap} "
                                     f"err={err}")
    log(f"  hrt1_unpack_resolve == plain on random bytes, n_cmds -1, 0, 1, "
        f"cap, 2 cap: widths {list(widths)}, caps 8, 4096, 40000, 43776, "
        f"deep and flat")
    return worst


# ---------------------------------------------------------------------------
# phases 6-9: K4, reference streams, Low Entropy / rle8m, MMTF
# ---------------------------------------------------------------------------

def k4_phase(dev, card: str):
    """K4 at the word microbenchmark's shape: both kernels on their main
    path (counts reset just before, read just after), then each equal to
    every plain formulation of its function, then the times."""
    rng = np.random.default_rng(0)
    pv = torch.from_numpy(rng.integers(-4, 5, (256, 2048, 128),
                                       dtype=np.int64).astype(np.float32)
                          ).to(dev).to(torch.bfloat16)
    api.reset_kernel_launch_counts()
    outs = {"word_slice_sum": micro_word.word_slice_sum(pv),
            "word_sampled_prefix": micro_word.word_sampled_prefix(pv)}
    torch.cuda.synchronize()
    counts = api.kernel_launch_counts()
    launches = {k: counts[k] for k in outs}
    errs = dict.fromkeys(outs, 0)
    for name, fn in micro_word.PLAIN.items():
        k = "word_slice_sum" if "slice" in name else "word_sampled_prefix"
        err = max_abs_err(outs[k], fn(pv))
        if err:
            raise AssertionError(f"{k} != plain {name!r}: err={err}")
        errs[k] = max(errs[k], err)
        log(f"  {k} == plain {name!r} on [256, 2048, 128] bf16")
    nb, R, row = pv.shape
    w = torch.tensor([4.0, 3.0, 2.0, 1.0], dtype=torch.bfloat16, device=dev)
    library = {   # one PyTorch call of each function, exact on these ints
        "word_slice_sum": lambda: torch.sum(
            pv.view(nb, R // 4, 4, row), 2, dtype=torch.int32),
        "word_sampled_prefix": lambda: torch.matmul(
            pv.view(nb, R // 4, 4, 32, 4), w)}
    t = graph_ms({k: (lambda fn=getattr(micro_word, k): fn(pv))
                  for k in outs}, calls=5)
    t.update(cuda_ms({**{n: (lambda fn=fn: fn(pv))
                         for n, fn in micro_word.PLAIN.items()},
                      **{f"library {k}": fn for k, fn in library.items()}},
                     reps=7, calls=5))
    gb = (pv.numel() * 2 + outs["word_slice_sum"].numel() * 4) / 1e9
    log(f"[{card}] K4 (128 MiB bf16 in, 64 MiB int32 out): "
        + "; ".join(f"{n} {ms:.4f} ms" for n, ms in t.items())
        + f"; kernels {gb / t['word_slice_sum'] * 1e3:.1f} / "
        f"{gb / t['word_sampled_prefix'] * 1e3:.1f} GB/s moved")
    plain = {"word_slice_sum": min(t["slice-only(bf16->f32 sum)"],
                                   t["slice-i32"]),
             "word_sampled_prefix": min(t["16 small matmuls"],
                                        t["4 fused [128,512]"],
                                        t["1 big [512,512]"])}
    times = {k: (t[k], plain[k], t[f"library {k}"]) for k in outs}
    io = nbytes(pv, outs["word_slice_sum"])
    n_out = outs["word_slice_sum"].numel()
    bounds = {"word_slice_sum": bound(io, 3 * n_out),
              "word_sampled_prefix": bound(io, 8 * n_out)}
    return launches, errs, times, bounds


def ref_rows(dct: bytes) -> dict:
    """name -> (raw, codec, blob) of the reference-stream rows."""
    t0 = time.perf_counter()
    rows = {"dct32_8bit": (dct[:32 * MIB], "8 Bit")}
    src = datasets.make_dataset(REF_MIB + 1, seed=5).tobytes()
    for codec in REF_CODECS:
        rows[codec] = (src[:REF_MIB * MIB + 13], codec)
    out = {}
    for name, (raw, codec) in rows.items():
        blob = registry.compress(raw, codec)
        out[name] = (raw, codec, blob)
        log(f"  ref input {name!r}: {len(raw)} B -> {len(blob)} B "
            f"({100 * len(blob) / len(raw):.2f}%)")
    log(f"ref inputs (host encoders): {time.perf_counter() - t0:.1f} s")
    return out


def decode_split(walk, dev, finish_stage: str, reps: int = 3):
    """One device decode in the stages its entry point runs: ``walk()`` ->
    ``(cols, B, finish)``, decode_sup.columns_to_device, the hrt1_decode
    kernel, ``finish`` on the device, the D2H copy; each closed by a
    synchronize, best of ``reps`` per stage (ms).  Returns the stages, the
    output bytes and hrt1_decode's max |error| against its plain version
    on the same device columns."""
    best = None
    for _ in range(reps):
        t = [time.perf_counter()]
        cols, B, finish = walk()
        t.append(time.perf_counter())
        cd = decode_sup.columns_to_device(cols, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        y = decode_sup.decode_columns_device(*cd, block_size=B)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        z = finish(y)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        (out,) = transfer.to_host(z)
        t.append(time.perf_counter())
        ms = np.diff(t) * 1e3
        best = ms if best is None else np.minimum(best, ms)
    err = max_abs_err(y, decode_sup.decode_columns_plain(*cd, block_size=B))
    stages = ("host_walk", "h2d", "kernel", finish_stage, "d2h")
    return dict(zip(stages, best.tolist())), out.tobytes(), err, cols


def ref_phase(dct: bytes, dev, card: str) -> int:
    """decompress_ref_device of every row (its main path, counted), then
    each row in its stages with hrt1_decode held against its plain
    version; returns the worst error."""
    rows = ref_rows(dct)
    api.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    outs = {name: ref_device.decompress_ref_device(blob, codec, device=dev)
            for name, (raw, codec, blob) in rows.items()}
    wall = time.perf_counter() - t0
    launches = api.kernel_launch_counts()
    if launches != {**dict.fromkeys(launches, 0), "hrt1_decode": len(rows)}:
        raise AssertionError(f"ref streams did not decode through "
                             f"hrt1_decode alone: {launches}")
    for name, (raw, codec, blob) in rows.items():
        if outs[name] != raw:
            raise AssertionError(f"decompress_ref_device({name}) != input")
    log(f"ref streams: {len(rows)} rows equal their input ({wall:.2f} s); "
        f"launches {launches}")
    worst = 0
    for name, (raw, codec, blob) in rows.items():
        def walk(blob=blob, codec=codec):
            cols, usize, s, B = ref_device.walk(blob,
                                                ref_device.codec_spec(codec))
            return cols, B, lambda y: ref_device.finish(y, usize, s)
        split, out, err, cols = decode_split(walk, dev, "reinterleave")
        if out != raw or err:
            raise AssertionError(f"ref stages ({name}): output equal "
                                 f"{out == raw}, hrt1_decode vs plain {err}")
        worst = max(worst, err)
        log(f"[{card}] ref stream split ({name}, {len(raw)} B, "
            f"{cols[0].shape[0]} blocks), best of 3: "
            + " | ".join(f"{k} {v:.2f}" for k, v in split.items())
            + " ms; hrt1_decode == plain on these columns")
    raw, codec, blob = rows["dct32_8bit"]
    w = best_wall(lambda: ref_device.decompress_ref_device(blob, codec,
                                                           device=dev), dev)
    log(f"[{card}] ref stream wall (32 MiB DCT, 8 Bit): whole call "
        f"{w * 1e3:.1f} ms best of 3 = {len(raw) / 1e9 / w:.3f} GB/s")
    return worst


def le_phase(dct: bytes, dev, card: str) -> int:
    """Low Entropy (+Short) of 4 MiB and an rle8m container of 32
    subsections of 4 MiB, decoded on the card (their main path, counted),
    then each in its stages with hrt1_decode held against its plain
    version; returns the worst error."""
    raw = dct[:4 * MIB]
    rows = {"le": (low_entropy.le_compress(raw),
                   low_entropy_device.le_decompress_device,
                   low_entropy_device.walk_le),
            "le_short": (low_entropy.le_compress(raw, short=True),
                         low_entropy_device.le_decompress_device,
                         low_entropy_device.walk_le),
            "rle8m_32": (low_entropy.rle8m_compress(32, raw),
                         low_entropy_device.rle8m_decompress_device,
                         low_entropy_device.walk_rle8m)}
    api.reset_kernel_launch_counts()
    for name, (blob, fn, _) in rows.items():
        if fn(blob, device=dev) != raw:
            raise AssertionError(f"{name} device decode != input")
    launches = api.kernel_launch_counts()
    if launches != {**dict.fromkeys(launches, 0), "hrt1_decode": len(rows)}:
        raise AssertionError(f"LE rows: launches {launches}")
    worst = 0
    for name, (blob, fn, walk_fn) in rows.items():
        def walk(blob=blob, walk_fn=walk_fn):
            cols, B, sizes = walk_fn(blob)
            return cols, B, lambda y: low_entropy_device.join(y, sizes)
        w = best_wall(lambda: fn(blob, device=dev), dev)
        sp, out, err, cols = decode_split(walk, dev, "join")
        if out != raw or err:
            raise AssertionError(f"LE stages ({name}): output equal "
                                 f"{out == raw}, hrt1_decode vs plain {err}")
        worst = max(worst, err)
        log(f"[{card}] {name}: {len(raw)} B from {len(blob)} B "
            f"({cols[0].shape[0]} blocks, {cols[0].shape[1]} command "
            f"slots), wall {w * 1e3:.1f} ms best of 3; stages "
            + " | ".join(f"{k} {v:.2f}" for k, v in sp.items())
            + f" ms; the Python walker is "
            f"{100 * sp['host_walk'] / sum(sp.values()):.1f}% of the "
            f"stages; hrt1_decode == plain on these columns")
    log(f"LE / rle8m: {len(rows)} rows equal their input; launches "
        f"{launches}")
    return worst


def mmtf_phase(dev, card: str):
    """mmtf_scan vs its plain version, mmtf_transform (its main path) vs the
    host format, the main path's scans vs the plain version at their
    shapes, Bit-MMTF round trips, times."""
    rng = np.random.default_rng(9)
    err = 0
    for lanes in (16, 32):
        x = torch.from_numpy(rng.integers(0, 256, (8, 4096), dtype=np.uint8)
                             ).to(dev)
        x[:4] = x[:4] % 7                       # skewed blocks beside random
        for encode in (True, False):
            k = mmtf_device.mmtf_scan(x, lanes=lanes, encode=encode)
            p = mmtf_device.mmtf_scan_plain(x, lanes=lanes, encode=encode)
            torch.cuda.synchronize()
            e = max(max_abs_err(a, b) for a, b in zip(k, p))
            if e:
                raise AssertionError(f"mmtf_scan != plain: lanes={lanes} "
                                     f"encode={encode} err={e}")
            err = max(err, e)
        log(f"  mmtf_scan == plain on [8, 4096], {lanes} lanes, both ways")
    C = mmtf_device.CHUNK
    shapes = ((2, 0), (1, 1), (3, 37), (1, C - 1), (1, C), (1, C + 1),
              (2, 2 * C - 1), (1, 2 * C), (1, 2 * C + 1))
    for lanes in (16, 32):
        for nb, units in shapes:
            x = torch.from_numpy(rng.integers(0, 256, (nb, units * lanes),
                                              dtype=np.uint8)).to(dev)
            x[:, ::3] %= 5
            for encode in (True, False):
                k = mmtf_device.mmtf_scan(x, lanes=lanes, encode=encode)
                p = mmtf_device.mmtf_scan_plain(x, lanes=lanes, encode=encode)
                torch.cuda.synchronize()
                e = max(max_abs_err(a, b) for a, b in zip(k, p))
                if e:
                    raise AssertionError(f"mmtf_scan != plain: [{nb}, "
                                         f"{units} units] lanes={lanes} "
                                         f"encode={encode} err={e}")
                err = max(err, e)
        log(f"  mmtf_scan == plain at the chunk edges (C = {C}): "
            f"{list(shapes)} (blocks, units), {lanes} lanes, both ways")
    data = datasets.make_dataset(2)[:MIB + 11].tobytes()
    api.reset_kernel_launch_counts()
    encs = {}
    for lanes in (16, 32):
        encs[lanes] = mmtf_device.mmtf_transform(data, lanes=lanes,
                                                 encode=True, device=dev)
        if encs[lanes] != mmtf._mmtf(data, lanes, encode=True):
            raise AssertionError(f"mmtf_transform({lanes}) != formats.mmtf")
        if mmtf_device.mmtf_transform(encs[lanes], lanes=lanes, encode=False,
                                      device=dev) != data:
            raise AssertionError(f"mmtf_transform({lanes}) round trip")
    launches = {"mmtf_scan": api.kernel_launch_counts()["mmtf_scan"]}
    log(f"mmtf_transform of {len(data)} B: 16 and 32 lanes equal "
        f"formats.mmtf and round-trip; launches {launches}")
    # the four scans of that path at their shapes, outputs and final tables
    # held against the plain version (~65 k steps of torch ops at 16 lanes,
    # each call timed once)
    plain_ms, x1 = {}, None
    for lanes in (16, 32):
        full = len(data) // lanes * lanes
        for encode, src in ((True, data), (False, encs[lanes])):
            x = torch.from_numpy(np.frombuffer(src, np.uint8)[:full].copy()
                                 ).to(dev)[None]
            k = mmtf_device.mmtf_scan(x, lanes=lanes, encode=encode)
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
            p = mmtf_device.mmtf_scan_plain(x, lanes=lanes, encode=encode)
            ev1.record()
            ev1.synchronize()
            plain_ms[lanes, encode] = ev0.elapsed_time(ev1)
            e = max(max_abs_err(a, b) for a, b in zip(k, p))
            if e:
                raise AssertionError(f"mmtf_scan != plain on the main path: "
                                     f"lanes={lanes} encode={encode} err={e}")
            err = max(err, e)
            if (lanes, encode) == (16, True):
                x1 = x
        log(f"  mmtf_scan == plain on the main path's [1, {full}], "
            f"{lanes} lanes, both ways")
    big = datasets.make_dataset(16)
    for unit, host in ((1, mmtf.bitmmtf8_encode), (2, mmtf.bitmmtf16_encode)):
        x = torch.from_numpy(big).to(dev)[None]
        enc = mmtf_device.bitmmtf_encode_device(x, unit=unit)
        if enc.cpu().numpy().tobytes() != host(big):
            raise AssertionError(f"Bit-MMTF {8 * unit} != host encode")
        if not torch.equal(mmtf_device.bitmmtf_decode_device(enc, unit=unit),
                           x):
            raise AssertionError(f"Bit-MMTF {8 * unit} round trip")
    log("Bit-MMTF 8 / 16: 16 MiB equal the host encode and round-trip")
    k1 = mmtf_device.mmtf_scan(x1, lanes=16, encode=True)
    # 1 MiB of uniform bytes (mean rank ~128): its encoding against the
    # host format, and the kernel's round trip
    rnd = np.random.default_rng(0).integers(0, 256, MIB, dtype=np.uint8)
    xr = torch.from_numpy(rnd).to(dev)[None]
    kr = mmtf_device.mmtf_scan(xr, lanes=16, encode=True)
    if kr[0][0].cpu().numpy().tobytes() != mmtf._mmtf(rnd.tobytes(), 16,
                                                      encode=True):
        raise AssertionError("mmtf_scan of 1 MiB uniform bytes != "
                             "formats.mmtf")
    if not torch.equal(mmtf_device.mmtf_scan(kr[0], lanes=16,
                                             encode=False)[0], xr):
        raise AssertionError("mmtf_scan round trip of 1 MiB uniform bytes")
    t = graph_ms({f"{name} {way}": (lambda x=x, e=way == "encode":
                                    mmtf_device.mmtf_scan(x, lanes=16,
                                                          encode=e))
                  for name, xe, xd in (("DCT", x1, k1[0]),
                                       ("uniform", xr, kr[0]))
                  for way, x in (("encode", xe), ("decode", xd))})
    # each byte's move to front walks its rank + 1 history entries
    ranks = k1[0].to(torch.int64)
    mmtf_bound = bound(nbytes(x1, *k1), float((ranks + 1).sum()))
    log(f"[{card}] mmtf_scan device time, 1 MiB, 16 lanes, one block "
        f"(C = {C}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; bound {mmtf_bound[0]:.4f} ms by {mmtf_bound[1]}; plain "
        f"(CUDA events, one call, DCT) encode {plain_ms[16, True]:.4f} ms "
        f"({MIB // 16} steps of torch ops), decode "
        f"{plain_ms[16, False]:.4f} ms, 32 lanes "
        f"{plain_ms[32, True]:.4f} / {plain_ms[32, False]:.4f} ms")
    return (launches, err, (t["DCT encode"], plain_ms[16, True], None),
            mmtf_bound)


# ---------------------------------------------------------------------------
# phases 10-11: distribution, device fuzz lane
# ---------------------------------------------------------------------------

def kernel_errs(xd, tl, B: int, cap: int) -> dict:
    """hrt1_encode and hrt1_decode against their plain versions on the
    blocks ``xd`` (lengths ``tl``) on their card: max |error| of each."""
    ek = encode_sup.encode_blocks_kernel(xd, tl, capacity=cap, min_count=6)
    pb = device.encode_blocks(xd, tl, capacity=cap, min_count=6)
    errs = {"hrt1_encode": max(max_abs_err(a, b) for a, b in zip(ek, (
        pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits))),
            "hrt1_decode": max_abs_err(
        decode_sup.decode_columns_device(*ek, tl, block_size=B),
        decode_sup.decode_columns_plain(*ek, tl, block_size=B))}
    torch.cuda.synchronize(xd.device)
    return errs


# what the rank scripts of phase 10 share: argv WORKDIR WORLD RANK, and
# kernel_errs (launches made after the rank has read its counts)
RANK_PRELUDE = r"""
import hashlib, json, os, pickle, sys, time
import numpy as np
import torch
import torch.distributed as tdist
from chip_smoke import kernel_errs
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.ops import planar, transfer
from hypersonic_rle_kit_tpu_torch.parallel import dist

workdir, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
"""

# one gloo rank of phase 10a; the stream is WORKDIR/data.bin; the ranks
# share card 0
DIST_RANK = RANK_PRELUDE + r"""
if not torch.cuda.is_available():
    raise SystemExit("rank: torch.cuda.is_available() is false")
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.initialize_multihost(num_processes=world, process_id=rank,
                          backend="gloo", timeout=300,
                          store=tdist.FileStore(f"{workdir}/store", world))
mesh = dist.make_mesh()
data = np.fromfile(f"{workdir}/data.bin", np.uint8)
B = 1 << 18
api.reset_kernel_launch_counts()
walls = []
for _ in range(3):                       # the first call warms up
    tdist.barrier()
    t0 = time.perf_counter()
    blob = dist.compress_distributed(data, mesh, block_size=B, device=dev)
    walls.append(time.perf_counter() - t0)
x, lens = api._to_blocks(data, B)
mine = slice(rank * x.shape[0] // world, (rank + 1) * x.shape[0] // world)
xd, tl = transfer.to_device(x[mine], dev), transfer.to_device(lens[mine], dev)
cap = planar.capacity_for(B, 6)
y, offsets, sizes = dist.pipeline_step(xd, tl, capacity=cap, min_count=6,
                                       mesh=mesh)
roundtrip = torch.equal(y, xd)
torch.cuda.synchronize()
launches = api.kernel_launch_counts()
errs = kernel_errs(xd, tl, B, cap)
if rank == 0:
    with open(f"{workdir}/blob.bin", "wb") as f:
        f.write(blob)
with open(f"{workdir}/rank{rank}.json", "w") as f:
    json.dump(dict(walls=walls, roundtrip=roundtrip, launches=launches,
                   errs=errs, sizes=sizes.tolist(),
                   offsets=offsets.tolist(), shape=list(xd.shape)), f)
tdist.destroy_process_group()
"""


def dist_phase(dct: bytes, native_blob: bytes, dev, card: str,
               single_wall: float) -> dict:
    """(a) two gloo ranks on the card: compress_distributed == native,
    pipeline_step round trip, both kernels launched on each rank and equal
    to their plain versions at its shapes; (b) one NCCL rank in this
    process: the exchange on CUDA tensors.  Returns the max |error| of
    hrt1_encode and hrt1_decode over the ranks."""
    B = 1 << 18
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as wd:
        np.frombuffer(dct, np.uint8).tofile(f"{wd}/data.bin")
        t0 = time.perf_counter()
        graft_entry.run_ranks([sys.executable, "-c", DIST_RANK], 2, wd,
                              timeout=300)
        ranks_s = time.perf_counter() - t0
        res = [json.loads(pathlib.Path(f"{wd}/rank{r}.json").read_text())
               for r in range(2)]
        blob = pathlib.Path(f"{wd}/blob.bin").read_bytes()
    if blob != native_blob:
        raise AssertionError("2-rank compress_distributed != native")
    for r, x in enumerate(res):
        if not x["roundtrip"]:
            raise AssertionError(f"rank {r}: pipeline_step != its blocks")
        for k in ("hrt1_encode", "hrt1_decode"):
            if x["launches"][k] < 1:
                raise AssertionError(f"rank {r} never launched {k}")
            if x["errs"][k]:
                raise AssertionError(f"rank {r}: {k} != plain on "
                                     f"{x['shape']}: err={x['errs'][k]}")
    sizes = np.array(res[0]["sizes"] + res[1]["sizes"], np.int64)
    if res[0]["offsets"] + res[1]["offsets"] != (np.cumsum(sizes)
                                                 - sizes).tolist():
        raise AssertionError("offsets != exclusive prefix of the sizes")
    # a timed call's wall is its slowest rank's; best of the two after the
    # warm-up
    wall = min(max(w) for w in zip(*(x["walls"][1:] for x in res)))
    log(f"distribution (a): 2 gloo ranks sharing one card, 64 MiB DCT in "
        f"256 KiB blocks: compress_distributed == native, pipeline_step "
        f"round trip equal, offsets == exclusive prefix, hrt1_encode and "
        f"hrt1_decode == plain on each rank's {res[0]['shape']} blocks; "
        f"launches rank 0 "
        f"{res[0]['launches']}, rank 1 {res[1]['launches']}; ranks ran "
        f"{ranks_s:.1f} s")
    log(f"[{card}] compress wall (64 MiB DCT, 8 Bit): 2 gloo ranks on one "
        f"card {wall * 1e3:.1f} ms (best of 2 after a warm-up, slowest "
        f"rank) vs single-process api.compress(backend='kernel') "
        f"{single_wall * 1e3:.1f} ms")

    raw = dct[:16 * MIB]
    want = api.compress(raw, "8 Bit", backend="native", device="cpu")
    on_wire = []
    all_gather = torch.distributed.all_gather

    def spy(out, t, *a, **k):
        on_wire.append(t.device.type)
        return all_gather(out, t, *a, **k)

    api.reset_kernel_launch_counts()
    with tempfile.TemporaryDirectory() as wd:
        dist.initialize_multihost(
            num_processes=1, process_id=0, backend="nccl",
            store=torch.distributed.FileStore(f"{wd}/store", 1))
        torch.distributed.all_gather = spy
        try:
            got = dist.compress_distributed(raw, dist.make_mesh(), device=dev,
                                            block_size=B)
        finally:
            torch.distributed.all_gather = all_gather
            torch.distributed.destroy_process_group()
    if got != want:
        raise AssertionError("NCCL compress_distributed != native")
    if not on_wire or set(on_wire) != {"cuda"}:
        raise AssertionError(f"NCCL exchange tensors on {on_wire}")
    encodes = api.kernel_launch_counts()["hrt1_encode"]
    if encodes < 1:
        raise AssertionError("the NCCL rank never launched hrt1_encode")
    log(f"distribution (b): 1 NCCL rank, 16 MiB: compress_distributed == "
        f"native; {len(on_wire)} all_gathers on CUDA tensors; hrt1_encode "
        f"launched {encodes}")
    return {k: max(x["errs"][k] for x in res)
            for k in ("hrt1_encode", "hrt1_decode")}


# one NCCL rank of phase 10c, on its own card (initialize_multihost makes
# it the current device); the ranks meet at the address in
# WORKDIR/coordinator, the streams are WORKDIR/<name>.bin, and
# WORKDIR/streams.json maps each name to the sha256 of its native container
NCCL_RANK = RANK_PRELUDE + r"""
with open(f"{workdir}/coordinator") as f:
    coordinator = f.read()
dist.initialize_multihost(coordinator, world, rank, backend="nccl",
                          timeout=600)
card = torch.cuda.current_device()
mesh, one = dist.make_mesh(), dist.make_mesh(1)
streams = json.loads(open(f"{workdir}/streams.json").read())
B = 1 << 18
cap = planar.capacity_for(B, 6)

# the collectives compress_distributed and pipeline_step call, timed and
# sized: (name, start, end, bytes sent, device type, device index)
calls = []
all_gather, all_gather_object = tdist.all_gather, tdist.all_gather_object

def spy(out, t, *a, **k):
    t0 = time.perf_counter()
    r = all_gather(out, t, *a, **k)
    torch.cuda.synchronize()
    calls.append(("all_gather", t0, time.perf_counter(), t.nbytes,
                  t.device.type, t.device.index))
    return r

def spy_object(out, obj, *a, **k):
    t0 = time.perf_counter()
    r = all_gather_object(out, obj, *a, **k)
    calls.append(("all_gather_object", t0, time.perf_counter(),
                  len(pickle.dumps(obj)), "cuda", torch.cuda.current_device()))
    return r

def compress(data, m):
    t0 = time.perf_counter()
    blob = dist.compress_distributed(data, m, block_size=B)
    return time.perf_counter() - t0, blob

props = torch.cuda.get_device_properties(card)
res = {"card": card, "name": props.name,
       "uuid": str(getattr(props, "uuid", "")),
       "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
for name, want in streams.items():
    data = np.fromfile(f"{workdir}/{name}.bin", np.uint8)
    r = res[name] = {}
    # walls at world N and at world 1 (rank 0 alone on a one-rank NCCL
    # group): a warm-up, then two timed calls
    for key, m in (("walls", mesh), ("walls1", one)):
        r[key] = []
        for _ in range(3):
            tdist.barrier()
            if m is one and rank:
                continue
            sec, blob = compress(data, m)
            if hashlib.sha256(blob).hexdigest() != want:
                raise AssertionError(f"rank {rank} {name} world "
                                     f"{tdist.get_world_size(m)}: "
                                     f"compress_distributed != native")
            r[key].append(sec)
    tdist.barrier()
    # the main path, counted and with its collectives recorded: one
    # compress_distributed at world N at its default device, then
    # pipeline_step on this rank's blocks
    x, lens = api._to_blocks(data, B)
    per = x.shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    xd = transfer.to_device(x[mine], torch.device("cuda", card))
    tl = transfer.to_device(lens[mine], torch.device("cuda", card))
    calls.clear()
    tdist.all_gather, tdist.all_gather_object = spy, spy_object
    api.reset_kernel_launch_counts()
    try:
        t0 = time.perf_counter()
        blob = dist.compress_distributed(data, mesh, block_size=B)
        t1 = time.perf_counter()
        y, offsets, sizes = dist.pipeline_step(xd, tl, capacity=cap,
                                               min_count=6, mesh=mesh)
        roundtrip = torch.equal(y, xd)
        torch.cuda.synchronize()
    finally:
        tdist.all_gather, tdist.all_gather_object = (all_gather,
                                                     all_gather_object)
    r["launches"] = api.kernel_launch_counts()
    if hashlib.sha256(blob).hexdigest() != want:
        raise AssertionError(f"rank {rank} {name}: counted "
                             f"compress_distributed != native")
    if rank == 0:
        with open(f"{workdir}/{name}.blob", "wb") as f:
            f.write(blob)
    r["calls"] = [(c[0], c[3], c[4], c[5]) for c in calls]
    stats, votes, parts = calls[:3]
    if [c[0] for c in calls] != ["all_gather"] * 2 + ["all_gather_object",
                                                      "all_gather"]:
        raise AssertionError(f"rank {rank}: collectives {r['calls']}")
    r["split_ms"] = {k: v * 1e3 for k, v in (
        ("encode", stats[1] - t0),
        ("exchange", stats[2] - stats[1] + votes[2] - votes[1]),
        ("serialize", parts[1] - stats[2] - (votes[2] - votes[1])),
        ("parts_gather", parts[2] - parts[1]),
        ("assemble", t1 - parts[2]))}
    r.update(roundtrip=roundtrip, sizes=sizes.tolist(),
             offsets=offsets.tolist(), shape=list(xd.shape),
             errs=kernel_errs(xd, tl, B, cap))
    del y, xd
    torch.cuda.empty_cache()
with open(f"{workdir}/rank{rank}.json", "w") as f:
    json.dump(res, f)
tdist.destroy_process_group()
"""


def free_address() -> str:
    """A ``host:port`` on this machine that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def nccl_ranks(streams: dict, natives: dict, world: int, dev, card: str,
               layout: str, cards: list, rank_env=None) -> tuple[dict, float]:
    """NCCL_RANK at world size ``world``, the ranks meeting at a coordinator
    address, on ``streams`` (name -> bytes, 256 KiB blocks): every rank's
    compress_distributed at its default device == the native container
    (``natives``), rank 0's blob round-trips on card 0, every rank's
    pipeline_step round-trips with exclusive-prefix offsets, both kernels
    launched on every rank and equal to their plain versions there, rank r
    on its card ``cards[r]`` (the index it sees) and on a card of its own,
    every collective there.  Logs the walls at world 1 and N, each rank's
    split and bytes.  Returns the max |error| of hrt1_encode and
    hrt1_decode over the ranks, and the first stream's wall at world N."""
    with tempfile.TemporaryDirectory() as wd:
        for name, raw in streams.items():
            pathlib.Path(f"{wd}/{name}.bin").write_bytes(raw)
        pathlib.Path(f"{wd}/streams.json").write_text(json.dumps(
            {n: hashlib.sha256(b).hexdigest() for n, b in natives.items()}))
        pathlib.Path(f"{wd}/coordinator").write_text(free_address())
        t0 = time.perf_counter()
        graft_entry.run_ranks([sys.executable, "-c", NCCL_RANK], world, wd,
                              timeout=600, rank_env=rank_env)
        ranks_s = time.perf_counter() - t0
        res = [json.loads(pathlib.Path(f"{wd}/rank{r}.json").read_text())
               for r in range(world)]
        blobs = {n: pathlib.Path(f"{wd}/{n}.blob").read_bytes()
                 for n in streams}
    if [x["card"] for x in res] != cards:
        raise AssertionError(f"NCCL ranks on cards {[x['card'] for x in res]}"
                             f", want {cards}")
    uuids = [x["uuid"] for x in res]
    if all(uuids) and len(set(uuids)) != world:
        raise AssertionError(f"two NCCL ranks on one card: {uuids}")
    on = ", ".join(f"{x['name']} cuda:{x['card']} of {x['visible'] or 'all'}"
                   for x in res)
    errs = dict.fromkeys(("hrt1_encode", "hrt1_decode"), 0)
    walls = {}
    for name, raw in streams.items():
        if blobs[name] != natives[name]:
            raise AssertionError(f"{name}: rank 0's blob != native")
        if api.decompress(blobs[name], device=dev) != raw:
            raise AssertionError(f"{name}: decompress on card 0 != input")
        rs = [x[name] for x in res]
        for r, x in enumerate(rs):
            if not x["roundtrip"]:
                raise AssertionError(f"{name} rank {r}: pipeline_step != "
                                     f"its blocks")
            for k in errs:
                if x["launches"][k] < 1:
                    raise AssertionError(f"{name} rank {r} never launched "
                                         f"{k}")
                if x["errs"][k]:
                    raise AssertionError(f"{name} rank {r}: {k} != plain on "
                                         f"{x['shape']}: {x['errs'][k]}")
                errs[k] = max(errs[k], x["errs"][k])
            if {(c[2], c[3]) for c in x["calls"]} != {("cuda", cards[r])}:
                raise AssertionError(f"{name} rank {r}: collectives on "
                                     f"{x['calls']}")
        sizes = np.concatenate([x["sizes"] for x in rs]).astype(np.int64)
        if np.concatenate([x["offsets"] for x in rs]).tolist() != (
                np.cumsum(sizes) - sizes).tolist():
            raise AssertionError(f"{name}: offsets != exclusive prefix of "
                                 f"the sizes")
        # a timed call's wall is its slowest rank's; best of the two after
        # the warm-up
        wall = walls[name] = min(max(w) for w in zip(*(x["walls"][1:]
                                                     for x in rs)))
        wall1 = min(rs[0]["walls1"][1:])
        mib = len(raw) >> 20
        log(f"[{card}] distribution (c), NCCL world size {world}, {layout} "
            f"({on}), {name} ({mib} MiB DCT, 256 KiB blocks, "
            f"{mib // world} MiB a rank): compress_distributed wall "
            f"{wall * 1e3:.1f} ms at world {world} vs {wall1 * 1e3:.1f} ms "
            f"at world 1 (slowest rank, best of 2 after a warm-up) = "
            f"{wall1 / wall:.2f}x")
        for r, x in enumerate(rs):
            sent = {}
            for c in x["calls"]:
                sent.setdefault(c[0], []).append(c[1])
            log(f"  [{card}] rank {r} split (ms): "
                + " | ".join(f"{k} {v:.1f}" for k, v in x["split_ms"].items())
                + f"; bytes sent: stats + vote all_gathers "
                f"{sent['all_gather'][:2]}, parts all_gather_object "
                f"{sent['all_gather_object']}, pipeline_step sizes "
                f"{sent['all_gather'][2:]}; launches {x['launches']}")
    log(f"distribution (c): NCCL world size {world}, {layout}: every rank "
        f"joined by coordinator address; every rank's compress_distributed "
        f"== native at its default device, round trips on card 0, "
        f"pipeline_step round trips, offsets == exclusive prefix, "
        f"hrt1_encode and hrt1_decode launched on every rank and == plain "
        f"there, every collective on the rank's own card; ranks ran "
        f"{ranks_s:.1f} s")
    return errs, walls[next(iter(streams))]


def two_hosts(r: int) -> dict:
    """Rank r's environment as one of two emulated hosts of two cards:
    ranks 0-1 see the first two cards, ranks 2-3 the next two, each with
    its LOCAL_RANK and LOCAL_WORLD_SIZE (torchrun's names)."""
    seen = os.environ.get("CUDA_VISIBLE_DEVICES", "0,1,2,3").split(",")
    return {"CUDA_VISIBLE_DEVICES": ",".join(seen[2 * (r // 2):
                                                  2 * (r // 2) + 2]),
            "LOCAL_RANK": str(r % 2), "LOCAL_WORLD_SIZE": "2"}


def nccl_phase(dct: bytes, native_blob: bytes, dev,
               card: str) -> tuple[dict, float]:
    """(c) NCCL at world size min(4, cards), one rank per card, joined by
    coordinator address: weak scaling on make_dataset(64 * world) and
    strong scaling on the 64 MiB corpus, 256 KiB blocks (nccl_ranks);
    with four cards the strong run again as two emulated hosts of two
    cards (rank_card's LOCAL_RANK path); then graft_entry's NCCL dry run.
    Returns the max |error| of hrt1_encode and hrt1_decode over the ranks
    and the 64 MiB wall at world N."""
    world = min(4, torch.cuda.device_count())
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(f"distribution (c): cards {cards}")
    weak = f"weak{64 * world}"
    streams = {"strong64": dct,
               weak: datasets.make_dataset(64 * world).tobytes()}
    natives = {"strong64": native_blob,
               weak: api.compress(streams[weak], "8 Bit", backend="native",
                                  device="cpu")}
    errs, wall = nccl_ranks(streams, natives, world, dev, card,
                            "one host, a rank per card", list(range(world)))
    if world == 4:
        e2, _ = nccl_ranks({"strong64": dct}, {"strong64": native_blob}, 4,
                           dev, card, "two emulated hosts of two cards",
                           [0, 1, 0, 1], rank_env=two_hosts)
        errs = {k: max(v, e2[k]) for k, v in errs.items()}
    try:
        graft_entry.dryrun_multichip(torch.cuda.device_count() + 1, "cuda")
    except ValueError as e:
        log(f"  dryrun_multichip({torch.cuda.device_count() + 1}, 'cuda') "
            f"refused: {e}")
    else:
        raise AssertionError("dryrun_multichip ran more NCCL ranks than "
                             "cards")
    graft_entry.dryrun_multichip(world, "cuda")
    log(f"distribution (c) in {time.perf_counter() - t_phase:.1f} s")
    return errs, wall


def mesh_split(data: bytes, mesh, B: int, reps: int = 2) -> dict:
    """compress_distributed on a LocalMesh in its stages, each closed by
    a synchronisation of every card: blocks padded to the mesh, copied to
    and encoded on every card (the launches, then one check) | the shares'
    columns to the host | one serialize.  Best of ``reps`` per stage (ms)
    after a warm-up; raises unless the bytes equal compress_distributed's."""
    cap = planar.capacity_for(B, 6)
    arr = np.frombuffer(data, np.uint8)
    real_nb = max(1, -(-arr.size // B))
    best = None
    for i in range(reps + 1):           # the first call warms up
        t = [time.perf_counter()]
        x, lens = dist._padded_blocks(arr, B, mesh.size)
        pbs = dist._encode_shares(x, lens, mesh, capacity=cap, min_count=6)
        for d in mesh.devices:
            torch.cuda.synchronize(d)
        t.append(time.perf_counter())
        cols = [c[:real_nb] for c in dist._shares_to_host(pbs)]
        t.append(time.perf_counter())
        blob = container.serialize_blocks(0, arr.size, B, 6, *cols)
        t.append(time.perf_counter())
        ms = np.diff(t) * 1e3
        if i:
            best = ms if best is None else np.minimum(best, ms)
        del pbs
    if blob != dist.compress_distributed(data, mesh, device=mesh.devices[0],
                                         block_size=B):
        raise AssertionError("LocalMesh stages != compress_distributed")
    return dict(zip(("encode_all_cards", "d2h", "serialize"), best.tolist()))


def mesh_phase(dct: bytes, native_blob: bytes, card: str,
               single_wall: float, rank_wall: float | None) -> tuple:
    """(d) one process, every card: dist.make_mesh() with no process group
    is the LocalMesh of the visible cards.  compress_distributed of the
    64 MiB corpus (256 KiB blocks) == native (sha256), launching
    hrt1_encode once on each card; pipeline_step on its blocks returns
    them on card 0 with exclusive-prefix offsets, launching hrt1_encode
    and hrt1_decode once on each card; on each card both kernels equal
    their plain versions on its share.  Logs the wall (best of 2 after a
    warm-up) and its split beside api.compress's and phase 10c's.  Returns
    (launches of the counted path, max |error| of each kernel)."""
    B = 1 << 18
    n_cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    mesh = dist.make_mesh()
    if not isinstance(mesh, dist.LocalMesh) or mesh.size != n_cards:
        raise AssertionError(f"make_mesh() without a group: {mesh}")
    want = hashlib.sha256(native_blob).hexdigest()
    api.reset_kernel_launch_counts()
    blob = dist.compress_distributed(dct, mesh, block_size=B)
    launches = api.kernel_launch_counts()
    if hashlib.sha256(blob).hexdigest() != want:
        raise AssertionError("LocalMesh compress_distributed != native")
    if launches["hrt1_encode"] != n_cards:
        raise AssertionError(f"compress_distributed on {n_cards} cards "
                             f"launched hrt1_encode {launches['hrt1_encode']}"
                             f" times")
    x, lens = api._to_blocks(np.frombuffer(dct, np.uint8), B)
    cap = planar.capacity_for(B, 6)
    api.reset_kernel_launch_counts()
    y, offsets, sizes = dist.pipeline_step(x, lens, capacity=cap,
                                           min_count=6, mesh=mesh)
    step = api.kernel_launch_counts()
    if y.device != mesh.devices[0] or not torch.equal(
            y.cpu(), torch.from_numpy(x)):
        raise AssertionError("LocalMesh pipeline_step != its blocks on "
                             "card 0")
    s64 = sizes.to(torch.int64)
    if not torch.equal(offsets, torch.cumsum(s64, 0) - s64):
        raise AssertionError("LocalMesh offsets != exclusive prefix")
    if step["hrt1_encode"] != n_cards or step["hrt1_decode"] != n_cards:
        raise AssertionError(f"pipeline_step on {n_cards} cards: {step}")
    del y
    for k in ("hrt1_encode", "hrt1_decode"):
        launches[k] += step[k]
    errs = dict.fromkeys(("hrt1_encode", "hrt1_decode"), 0)
    per = x.shape[0] // n_cards
    for i, d in enumerate(mesh.devices):
        share = slice(i * per, (i + 1) * per)
        e = kernel_errs(transfer.to_device(x[share], d),
                        transfer.to_device(lens[share], d), B, cap)
        if any(e.values()):
            raise AssertionError(f"{d}: kernels != plain on its share: {e}")
        errs = {k: max(v, e[k]) for k, v in errs.items()}
    log(f"distribution (d), one process, every card ({n_cards} x "
        f"{torch.cuda.get_device_name(0)}): compress_distributed(dct64, "
        f"make_mesh()) == native; pipeline_step round trip on cuda:0, "
        f"offsets == exclusive prefix; launches {dict(launches)} (each "
        f"kernel once a card a call); hrt1_encode and hrt1_decode == plain "
        f"on every card's {per} blocks")
    walls = {}
    for m in sorted({1, n_cards}):
        sub = dist.make_mesh(m)
        dist.compress_distributed(dct, sub, block_size=B)   # warm-up
        walls[m] = best_wall(lambda: dist.compress_distributed(
            dct, sub, block_size=B), mesh.devices[0], reps=2)
        split = mesh_split(dct, sub, B)
        log(f"[{card}] LocalMesh compress_distributed (64 MiB DCT, 256 KiB "
            f"blocks) on {m} card(s): wall {walls[m] * 1e3:.1f} ms (best of "
            f"2 after a warm-up); split (ms, best of 2 after a warm-up): "
            + " | ".join(f"{k} {v:.2f}" for k, v in split.items()))
    log(f"[{card}] compress wall (64 MiB DCT): LocalMesh of {n_cards} "
        f"card(s) {walls[n_cards] * 1e3:.1f} ms; api.compress(backend="
        f"'kernel') {single_wall * 1e3:.1f} ms; phase 10c, a rank per card "
        + ("not run (one card)" if rank_wall is None
           else f"{rank_wall * 1e3:.1f} ms (slowest rank)"))
    return launches, errs


def fuzz_phase(dev, card: str) -> None:
    """The device fuzz lane on the card."""
    inputs = list(itertools.chain(fuzz.random_inputs(6, 10), itertools.islice(
        fuzz.iterative_inputs(6), 10)))
    specs = [spec.by_name(n) for n in fuzz.DEVICE_FUZZ_CODECS]
    api.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    failures = fuzz.run_device(inputs, specs, log=log, device=dev)
    torch.cuda.synchronize()            # raises on a sticky CUDA error
    secs = time.perf_counter() - t0
    launches = api.kernel_launch_counts()
    if failures:
        raise AssertionError("device fuzz lane failed")
    for k in ("hrt1_decode", "hrt1_unpack_resolve"):
        if launches[k] < 1:
            raise AssertionError(f"device fuzz lane never launched {k}")
    log(f"[{card}] device fuzz lane: {len(inputs)} inputs x {len(specs)} "
        f"codecs ({len(inputs) * len(specs)} containers, each with 4 "
        f"mutations and 3 truncations) clean in {secs:.1f} s; launches "
        f"{launches}")


def bench_phase(card: str) -> None:
    """The port's bench in this process at its defaults; prints its JSON
    object on a line of its own."""
    t0 = time.perf_counter()
    line = bench.run(bench.parse_args([]))
    gbps = {k: v for k, v in line.items() if k.endswith("_gbps")}
    if line["ok"] is not True or not all(v > 0 for v in gbps.values()):
        raise AssertionError(f"bench: ok {line['ok']}, rates {gbps}")
    log(f"[{card}] bench (64 MiB DCT, 256 KiB blocks): {len(gbps)} rates "
        f"> 0, headline {line['value']:.2f} GB/s, in "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _kernels.build()
    for name in _kernels.LIBRARIES:
        _kernels.lib(name)
    log(f"build: nvcc {' '.join(_kernels.NVCC_FLAGS)} -> "
        + ", ".join(_kernels.library_path(n).name for n in _kernels.LIBRARIES)
        + f" in {time.perf_counter() - t0:.2f} s")

    # ---- inputs of the main paths: (raw, codec) and native blobs ----
    t0 = time.perf_counter()
    dct = datasets.make_dataset(64).tobytes()
    dct16 = datasets.make_dataset(17)[:16 * MIB + 1001].tobytes()
    crows = {"dct64": (dct, "8 Bit"),
             "dct64_single": (dct, "8 Bit Single"),
             "random16": (datasets.make_random_dataset(16).tobytes(), "8 Bit"),
             "bwt16": (datasets.make_bwt_dataset(16).tobytes(), "8 Bit"),
             "dct16_w32": (dct16[:16 * MIB], "32 Bit (Symbol)"),
             "dct16p_w24": (dct16, "24 Bit (Symbol)")}
    native_blobs = {name: api.compress(raw, codec, backend="native",
                                       device="cpu")
                    for name, (raw, codec) in crows.items()}
    blob = native_blobs["dct64"]
    info, _ = container.parse(blob)
    if not (info.deep and info.litdict and info.block_size == 1 << 18):
        raise AssertionError(f"DCT container is not deep+litdict: {info}")
    B = info.block_size
    x, lens = api._to_blocks(np.frombuffer(dct, np.uint8), B)
    cols = native.planar_from_bytes(x, lens, planar.capacity_for(B, 6), 6)
    flat = container.serialize_blocks(0, len(dct), B, 6, *cols, deep=False)
    for name, b in native_blobs.items():
        i, _ = container.parse(b)
        raw = crows[name][0]
        log(f"  input {name} ({crows[name][1]}): {len(raw)} B -> {len(b)} B "
            f"({100 * len(b) / len(raw):.2f}%), deep={i.deep} "
            f"litdict={i.litdict} B={i.block_size}")
    log(f"inputs: {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels vs plain ----
    err_k1 = check_decode_cases(dev)
    packs = {}
    for name, b in (("dct64", blob), ("dct64_flat", flat)):
        p = container.pack_for_device(b)
        packs[name] = (p, unpack_device.ship_packed(p, dev))
    err_k2 = check_unpack_cases(dev, packs)
    for name, pa in packs.items():
        words, bad = section_decode(*pa)
        e = max(max_abs_err(words, unpack_device.dispatch_packed(
            *pa, out_words=True)), max_abs_err(words, plain_dispatch(*pa)))
        if e or (bad is not None and int(bad.abs().sum())):
            raise AssertionError(f"section decoder of {name} != "
                                 f"dispatch_packed / plain: err={e}")
    log("  decode_deep_device (dct64 deep) and decode_payload_device "
        "(dct64 flat) == dispatch_packed == their plain versions; no bad "
        "flag")
    pk, arrs = packs["dct64"]
    args, kw = unpack_device.section_args(pk, arrs)
    fargs, fkw = unpack_device.section_args(*packs["dct64_flat"])
    rk = unpack_device.unpack_resolve(*args, **kw)
    fk = unpack_device.unpack_resolve(*fargs, **fkw)
    dargs = (rk[2], rk[0], rk[1], arrs["lits"], arrs["n_cmds"],
             arrs["n_lits"], arrs["block_len"])
    yk = decode_sup.decode_columns_device(*dargs, block_size=B,
                                          out_words=True)
    yp = decode_sup.decode_columns_plain(*dargs, block_size=B,
                                         out_words=True)
    err_k1 = max(err_k1, max_abs_err(yk, yp))
    if err_k1:
        raise AssertionError(f"hrt1_decode != plain on the DCT columns")
    log("  hrt1_decode == plain on the DCT container's resolved columns")
    err_k3 = check_encode_cases(dev)
    e3, e1 = check_extremes(dev)
    err_k3, err_k1 = max(err_k3, e3), max(err_k1, e1)
    cap = planar.capacity_for(B, 6)
    xd, tl = transfer.to_device(x, dev), transfer.to_device(lens, dev)
    ek = encode_sup.encode_blocks_kernel(xd, tl, capacity=cap, min_count=6)
    pb = device.encode_blocks(xd, tl, capacity=cap, min_count=6)
    err_k3 = max(err_k3, max(max_abs_err(a, b) for a, b in zip(ek, (
        pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits))))
    if err_k3:
        raise AssertionError("hrt1_encode != plain on the DCT blocks")
    log("  hrt1_encode == plain on the 64 MiB DCT blocks")
    del ek, pb

    # ---- 4. main paths: compress, then decompress ----
    api.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    blobs = {name: api.compress(raw, codec, backend="kernel", device=dev)
             for name, (raw, codec) in crows.items()}
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    launches = {"hrt1_encode": api.kernel_launch_counts()["hrt1_encode"]}
    for name, b in blobs.items():
        if b != native_blobs[name]:
            raise AssertionError(f"compress({name}, kernel) != native")
    log(f"main path, compress: {len(blobs)} rows equal backend='native' "
        f"({comp_s:.2f} s of compress); launches {launches}")

    rows = {name: (b, crows[name][0]) for name, b in blobs.items()}
    rows["dct64_flat"] = (flat, dct)
    api.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    outs = {name: api.decompress(b, device=dev)
            for name, (b, raw) in rows.items()}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    dl = api.kernel_launch_counts()
    launches.update(hrt1_decode=dl["hrt1_decode"],
                    hrt1_unpack_resolve=dl["hrt1_unpack_resolve"])
    for name, (b, raw) in rows.items():
        if outs[name] != raw:
            raise AssertionError(f"decompress({name}) != input")
    log(f"main path, decompress: {len(rows)} round trips equal their input "
        f"({main_s:.2f} s of decompress); launches {dl}")
    for k in ("hrt1_decode", "hrt1_unpack_resolve", "hrt1_encode"):
        if launches[k] < 1:
            raise AssertionError(f"{k} never launched on the main path")
    del outs

    # ---- 5. times: device time of one call (CUDA graph replays), and the
    # CUDA-event time of back-to-back calls, host work included ----
    kt = graph_ms({
        "hrt1_decode": lambda: decode_sup.decode_columns_device(
            *dargs, block_size=B, out_words=True),
        "hrt1_unpack_resolve": lambda: unpack_device.unpack_resolve(
            *args, **kw),
        "unpack_resolve flat": lambda: unpack_device.unpack_resolve(
            *fargs, **fkw),
        "hrt1_encode": lambda: encode_sup._launch(xd, tl, None, cap, 6),
        **{f"dispatch {n}": (lambda pa=pa: unpack_device.dispatch_packed(
            *pa, out_words=True)) for n, pa in packs.items()},
        **{f"sections {n}": (lambda pa=pa: section_decode(*pa))
           for n, pa in packs.items()}})
    kt.update(cuda_ms({
        "decode_plain": lambda: decode_sup.decode_columns_plain(
            *dargs, block_size=B, out_words=True),
        "unpack_plain": lambda: unpack_device.unpack_resolve_plain(
            *args, **kw),
        "unpack_plain flat": lambda: unpack_device.unpack_resolve_plain(
            *fargs, **fkw),
        "encode_plain": lambda: device.encode_blocks(
            xd, tl, capacity=cap, min_count=6)}, reps=5, calls=4))
    ev = cuda_ms({
        "hrt1_decode": lambda: decode_sup.decode_columns_device(
            *dargs, block_size=B, out_words=True),
        "hrt1_encode": lambda: encode_sup._launch(xd, tl, None, cap, 6),
        "encode_checked": lambda: encode_sup.encode_blocks_kernel(
            xd, tl, capacity=cap, min_count=6)}, reps=7, calls=5)
    n_cmds_sum = int(arrs["n_cmds"].sum())
    n_lits_sum = int(arrs["n_lits"].sum())
    nb_ = x.shape[0]
    bounds = {
        # the commands and literals the blocks hold, read once; the words
        # written once
        "hrt1_decode": bound(9 * n_cmds_sum + n_lits_sum + 8 * nb_
                             + 4 * nb_ * (B // 4), nb_ * B),
        # the packed values the blocks hold read once; count, lit_len, sym,
        # bad written once
        "hrt1_unpack_resolve": bound(unpack_bytes(args, kw, rk)),
        "unpack_resolve flat": bound(unpack_bytes(fargs, fkw, fk)),
        # x read once; literal rows and fixed-capacity columns written once
        "hrt1_encode": bound(2 * nb_ * B + 9 * nb_ * cap + 12 * nb_,
                             nb_ * B),
    }
    gb = len(dct) / 1e9
    for k, p in (("hrt1_decode", "decode_plain"),
                 ("hrt1_unpack_resolve", "unpack_plain"),
                 ("unpack_resolve flat", "unpack_plain flat"),
                 ("hrt1_encode", "encode_plain")):
        log(f"[{card}] {k}: device {kt[k]:.4f} ms ({gb / kt[k] * 1e3:.2f} "
            f"GB/s of {len(dct) >> 20} MiB DCT, {nb_} blocks), bound "
            f"{bounds[k][0]:.4f} ms by {bounds[k][1]} = "
            f"{100 * bounds[k][0] / kt[k]:.1f}% of it; plain {kt[p]:.4f} ms")
    log(f"[{card}] CUDA events over back-to-back calls: hrt1_decode wrapper "
        f"{ev['hrt1_decode']:.4f} ms, hrt1_encode launch "
        f"{ev['hrt1_encode']:.4f} ms, checked wrapper "
        f"{ev['encode_checked']:.4f} ms")
    for name, pa in packs.items():
        ops = graph_ops(lambda: unpack_device.dispatch_packed(
            *pa, out_words=True))
        if ops > 4:
            raise AssertionError(f"dispatch_packed {name}: {ops} device "
                                 f"operations a call, want at most 4")
        dt = cuda_ms({
            "kernels": lambda: unpack_device.dispatch_packed(
                *pa, out_words=True),
            "plain": lambda: plain_dispatch(*pa)})
        mb = len(dct) / 1e6
        log(f"[{card}] dispatch_packed {name}: {ops:g} device operations a "
            f"call; device {kt[f'dispatch {name}']:.4f} ms = "
            f"{mb / kt[f'dispatch {name}']:.2f} GB/s; CUDA events "
            f"{dt['kernels']:.4f} ms = {mb / dt['kernels']:.2f} GB/s; plain "
            f"{dt['plain']:.4f} ms = {mb / dt['plain']:.2f} GB/s")
    log(f"[{card}] section decoders, device time: decode_deep_device "
        f"(dct64 deep) {kt['sections dct64']:.4f} ms, decode_payload_device "
        f"(dct64 flat) {kt['sections dct64_flat']:.4f} ms; dispatch_packed "
        f"{kt['dispatch dct64']:.4f} / {kt['dispatch dct64_flat']:.4f} ms")
    for name in ("dct64", "dct16_w32"):
        b, raw = rows[name]
        w = best_wall(lambda: api.decompress(b, device=dev), dev)
        log(f"[{card}] decompress wall ({name}, host pack + copies + "
            f"kernels + device re-interleave + D2H): {w * 1e3:.1f} ms best "
            f"of 3 = {len(raw) / 1e9 / w:.3f} GB/s")
    split = compress_split(dct, dev)
    wk = best_wall(lambda: api.compress(dct, "8 Bit", backend="kernel",
                                        device=dev), dev)
    wn = best_wall(lambda: api.compress(dct, "8 Bit", backend="native",
                                        device="cpu"), dev)
    log(f"[{card}] compress wall (64 MiB DCT, 8 Bit), best of 3: stages "
        + " | ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f" ms; api.compress kernel {wk * 1e3:.1f} ms, native "
        f"{wn * 1e3:.1f} ms")

    errs = {"hrt1_decode": err_k1, "hrt1_unpack_resolve": err_k2,
            "hrt1_encode": err_k3}
    times = {k: (kt[k], kt[p], None) for k, p in (
        ("hrt1_decode", "decode_plain"), ("hrt1_unpack_resolve", "unpack_plain"),
        ("hrt1_encode", "encode_plain"))}

    # ---- 6-9. K4, reference streams, Low Entropy / rle8m, MMTF ----
    k4_launches, k4_errs, k4_times, k4_bounds = k4_phase(dev, card)
    launches.update(k4_launches)
    errs.update(k4_errs)
    times.update(k4_times)
    bounds.update(k4_bounds)
    errs["hrt1_decode"] = max(errs["hrt1_decode"],
                              ref_phase(dct, dev, card),
                              le_phase(dct, dev, card))
    (mmtf_launches, errs["mmtf_scan"], times["mmtf_scan"],
     bounds["mmtf_scan"]) = mmtf_phase(dev, card)
    launches.update(mmtf_launches)
    for k in KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"{k} never launched on its main path")

    # ---- 10-11. distribution, device fuzz lane ----
    for k, e in dist_phase(dct, native_blobs["dct64"], dev, card,
                           wk).items():
        errs[k] = max(errs[k], e)
    rank_wall = None
    if torch.cuda.device_count() >= 2:
        nccl_errs, rank_wall = nccl_phase(dct, native_blobs["dct64"], dev,
                                          card)
        for k, e in nccl_errs.items():
            errs[k] = max(errs[k], e)
    else:
        log("distribution (c): skipped, one card (NCCL needs a card per "
            "rank)")
    mesh_launches, mesh_errs = mesh_phase(dct, native_blobs["dct64"], card,
                                          wk, rank_wall)
    for k, e in mesh_errs.items():
        errs[k] = max(errs[k], e)
        launches[k] += mesh_launches[k]
    fuzz_phase(dev, card)

    # ---- 12. the port's bench at its defaults ----
    bench_phase(card)

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        dict(name=k, **meta, launches=launches[k], max_abs_err=errs[k],
             ms=times[k][0], plain_ms=times[k][1], bound_ms=bounds[k][0],
             bound_by=bounds[k][1], library_ms=times[k][2])
        for k, meta in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
