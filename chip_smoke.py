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
   0 and W % 4 != 0 take the unvectorised paths), hrt1_resolve_deep on the
   deep sections of a real container, and hrt1_encode on synthetic blocks
   (the same edges plus Single, min_count 4; 4 KiB, 20011 B, 64 KiB,
   192 KiB and 256 KiB blocks); a 4 MiB one-block stream through both; a
   capacity of exactly the commands (padding by the tail tile), one less
   raising.  Each byte-equal to its plain torch version on the same card
   tensors.
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
   plain version, of the wrappers and of dispatch_packed on shipped
   sections (deep and flat);
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
9. MMTF: mmtf_scan equal to its plain version on [8, 4096] (16 and 32
   lanes, both ways); mmtf_transform of 1 MiB + 11 B (its main path,
   counted) equal to formats.mmtf and round-tripping, and its four scans
   equal to the plain version at their shapes; Bit-MMTF 8 / 16 on
   16 MiB; mmtf_scan timed on 1 MiB beside its plain version.
10. distribution: (a) two gloo ranks, fresh interpreters sharing the card,
    run parallel/dist.compress_distributed on the 64 MiB DCT corpus
    (256 KiB blocks), whose bytes must equal the native container, and
    pipeline_step on the same blocks, which must return them; each rank
    must have launched hrt1_encode and hrt1_decode, and then holds both
    against their plain versions on its blocks.  (b) one NCCL rank in
    this process (world size 1) compresses 16 MiB the same way, so the
    exchange runs on CUDA tensors once.  Logs the two-rank wall beside the
    single-process compress wall.
11. device fuzz lane: fuzz.run_device on the card over 20 inputs (10
    random, 10 iterative) x the 10 DEVICE_FUZZ_CODECS: round trips, 4
    mutated and 3 truncated containers each; no failure, and hrt1_decode
    and hrt1_resolve_deep must have launched.

The line before the last is one JSON object with each kernel's route,
source, replaced TPU kernel, launches, max |error|, times (the kernel's
device time; CUDA-event times of its plain version and of one PyTorch call
where there is one), and its bound from
this run's inputs (bytes each read or written once at 3.35 TB/s, or
operations at 67 TFLOP/s, the larger); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hypersonic_rle_kit_tpu_torch import (api, datasets, fuzz, graft_entry,
                                          spec)
from hypersonic_rle_kit_tpu_torch.formats import low_entropy, mmtf, registry
from hypersonic_rle_kit_tpu_torch.ops import (_kernels, decode_sup, device,
                                              encode_sup, low_entropy_device,
                                              micro_word, mmtf_device, planar,
                                              ref_device, transfer,
                                              unpack_device)
from hypersonic_rle_kit_tpu_torch.parallel import container, dist
from hypersonic_rle_kit_tpu_torch.utils import native

MIB = 1 << 20
TILE = 16384            # the encode and decode kernels' tile bytes
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12
KERNELS = {
    "hrt1_decode": dict(
        route="cuda", source="hypersonic_rle_kit_tpu_torch/csrc/hrt1_decode.cu",
        replaces="hypersonic_rle_kit_tpu/ops/decode_sup.py:631"),
    "hrt1_resolve_deep": dict(
        route="cuda",
        source="hypersonic_rle_kit_tpu_torch/csrc/hrt1_resolve.cu",
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fns: dict, reps: int = 11, calls: int = 10) -> dict:
    """Median CUDA-event ms per call of each callable.  A sample is
    ``calls`` back-to-back calls between two events, so the host queues
    launches ahead of the card; versions run in turns after a warm-up, so
    the ones compared share the card's state."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for r in range(reps):
        order = list(fns) if r % 2 == 0 else list(reversed(fns))
        for k in order:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(calls):
                fns[k]()
            e.record()
            e.synchronize()
            times[k].append(s.elapsed_time(e) / calls)
    return {k: statistics.median(v) for k, v in times.items()}


def graph_ms(fns: dict, reps: int = 7, calls: int = 10) -> dict:
    """Device time of one call of each callable: ``calls`` calls captured
    in a CUDA graph, the graph's replays timed with CUDA events (median of
    ``reps``), so the host work of a kernel's wrapper, which can outlast
    the kernel, is not counted.  The callables must not synchronise."""
    out = {}
    cur = torch.cuda.current_stream()
    for k, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()                          # warm-up outside the capture
        cur.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / calls)
        out[k] = statistics.median(times)
        del g
    return out


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes each read or written
    once over HBM, or the operations over the float32 rate, the larger."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
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


def deep_planes(pk: dict, arrs: dict):
    """The resolver's inputs at the main path's shapes."""
    cap = pk["capacity"]
    planes = [unpack_device._unpack_wide(arrs[k], bits, cap) for k, bits in (
        ("cnts_raw", pk["cnt_bits"]), ("cnt_ovf_raw", pk["cnt_ovf_bits"]),
        ("lls_raw", pk["lit_bits"]), ("ll_ovf_raw", pk["ll_ovf_bits"]),
        ("lut_raw", 3))]
    kw = dict(cap=cap, cnt_bits=pk["cnt_bits"] if pk["cnt_ovf_bits"] else 0,
              lit_bits=pk["lit_bits"] if pk["ll_ovf_bits"] else 0,
              min_count=pk["info"].min_count)
    return (*planes, arrs["miss_raw"], arrs["dict7"], arrs["n_cmds"]), kw


def plain_dispatch(pk: dict, arrs: dict):
    """dispatch_packed with each kernel replaced by its plain version."""
    info = pk["info"]
    cap = pk["capacity"]
    if info.deep:
        args, kw = deep_planes(pk, arrs)
        count, lit_len, sym = unpack_device.resolve_deep_plain(*args, **kw)
    else:
        idx = torch.arange(cap, dtype=torch.int32, device=arrs["lits"].device)
        nc = arrs["n_cmds"][:, None]
        count = torch.where(idx < nc - 1, unpack_device._unpack_wide(
            arrs["cnts_raw"], pk["cnt_bits"], cap) + info.min_count, 0)
        lit_len = torch.where(idx < nc, unpack_device._unpack_wide(
            arrs["lls_raw"], pk["lit_bits"], cap), 0)
        sym = arrs["syms"]
    return decode_sup.decode_columns_plain(
        sym, count.to(torch.int32), lit_len.to(torch.int32), arrs["lits"],
        arrs["n_cmds"], arrs["n_lits"], arrs["block_len"],
        block_size=info.block_size, out_words=True)


# ---------------------------------------------------------------------------

def best_wall(fn, reps: int = 3) -> float:
    """Best-of-``reps`` host seconds of ``fn`` closed by a synchronize."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def compress_split(raw: bytes, dev, reps: int = 3) -> dict:
    """api.compress(backend="kernel") of an "8 Bit" stream in its stages,
    each closed by a synchronize; best of ``reps`` per stage (ms)."""
    B = container.DEFAULT_BLOCK_SIZE
    cap = planar.capacity_for(B, 6)
    best = None
    for _ in range(reps):
        t = [time.perf_counter()]
        x, lens = api._to_blocks(np.frombuffer(raw, np.uint8), B)
        xd, tl = transfer.to_device(x, dev), transfer.to_device(lens, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        cols = encode_sup.encode_blocks_kernel(xd, tl, capacity=cap,
                                               min_count=6)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        hc = api._columns_to_host(*cols)
        t.append(time.perf_counter())
        blob = container.serialize_blocks(0, len(raw), B, 6, *hc)
        t.append(time.perf_counter())
        ms = np.diff(t) * 1e3
        best = ms if best is None else np.minimum(best, ms)
    if blob != api.compress(raw, "8 Bit", backend="native", device="cpu"):
        raise AssertionError("compress stages != native compress")
    return dict(zip(("to_blocks_h2d", "encode", "d2h", "serialize"),
                    best.tolist()))


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
                                                           device=dev))
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
        w = best_wall(lambda: fn(blob, device=dev))
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
    # a one-block scan runs for milliseconds: CUDA events, host work
    # negligible beside it
    t = cuda_ms({"mmtf_scan": lambda: mmtf_device.mmtf_scan(
        x1, lanes=16, encode=True)}, reps=5, calls=2)["mmtf_scan"]
    # each byte's move to front walks its rank + 1 history entries
    ranks = k1[0].to(torch.int64)
    mmtf_bound = bound(nbytes(x1, *k1), float((ranks + 1).sum()))
    log(f"[{card}] mmtf_scan, 1 MiB DCT, 16 lanes, one block: kernel "
        f"{t:.4f} ms, plain {plain_ms[16, True]:.4f} ms ({MIB // 16} steps "
        f"of torch ops); plain 16-lane decode {plain_ms[16, False]:.4f} ms, "
        f"32 lanes {plain_ms[32, True]:.4f} / {plain_ms[32, False]:.4f} ms")
    return launches, err, (t, plain_ms[16, True], None), mmtf_bound


# ---------------------------------------------------------------------------
# phases 10-11: distribution, device fuzz lane
# ---------------------------------------------------------------------------

# one gloo rank of phase 10a: argv WORKDIR WORLD RANK; the stream is
# WORKDIR/data.bin; the ranks share card 0
DIST_RANK = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as tdist
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.ops import (decode_sup, device, encode_sup,
                                              planar, transfer)
from hypersonic_rle_kit_tpu_torch.parallel import container, dist
from hypersonic_rle_kit_tpu_torch.utils import native

def err(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

workdir, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
if not torch.cuda.is_available():
    raise SystemExit("rank: torch.cuda.is_available() is false")
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.initialize_multihost(tdist.FileStore(f"{workdir}/store", world), world,
                          rank, backend="gloo", timeout=300)
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
# both kernels against their plain versions at this rank's shapes (these
# launches come after the count is read)
ek = encode_sup.encode_blocks_kernel(xd, tl, capacity=cap, min_count=6)
pb = device.encode_blocks(xd, tl, capacity=cap, min_count=6)
errs = {"hrt1_encode": max(err(a, b) for a, b in zip(ek, (
    pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits))),
        "hrt1_decode": err(
    decode_sup.decode_columns_device(*ek, tl, block_size=B),
    decode_sup.decode_columns_plain(*ek, tl, block_size=B))}
torch.cuda.synchronize()
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
            torch.distributed.FileStore(f"{wd}/store", 1), 1, 0,
            backend="nccl")
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
    for k in ("hrt1_decode", "hrt1_resolve_deep"):
        if launches[k] < 1:
            raise AssertionError(f"device fuzz lane never launched {k}")
    log(f"[{card}] device fuzz lane: {len(inputs)} inputs x {len(specs)} "
        f"codecs ({len(inputs) * len(specs)} containers, each with 4 "
        f"mutations and 3 truncations) clean in {secs:.1f} s; launches "
        f"{launches}")


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
    pk = container.pack_for_device(blob)
    arrs = unpack_device.ship_packed(pk, dev)
    args, kw = deep_planes(pk, arrs)
    rk = unpack_device._resolve_deep(*args, **kw)
    rp = unpack_device.resolve_deep_plain(*args, **kw)
    torch.cuda.synchronize()
    err_k2 = max(max_abs_err(a, b) for a, b in zip(rk, rp))
    if err_k2:
        raise AssertionError(f"hrt1_resolve_deep != plain: err={err_k2}")
    log(f"  hrt1_resolve_deep == plain on the DCT container's sections "
        f"({pk['info'].n_blocks} blocks, cap {pk['capacity']})")
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
                    hrt1_resolve_deep=dl["hrt1_resolve_deep"])
    for name, (b, raw) in rows.items():
        if outs[name] != raw:
            raise AssertionError(f"decompress({name}) != input")
    log(f"main path, decompress: {len(rows)} round trips equal their input "
        f"({main_s:.2f} s of decompress); launches {dl}")
    for k in ("hrt1_decode", "hrt1_resolve_deep", "hrt1_encode"):
        if launches[k] < 1:
            raise AssertionError(f"{k} never launched on the main path")
    del outs

    # ---- 5. times: device time of one call (CUDA graph replays), and the
    # CUDA-event time of back-to-back calls, host work included ----
    kt = graph_ms({
        "hrt1_decode": lambda: decode_sup.decode_columns_device(
            *dargs, block_size=B, out_words=True),
        "hrt1_resolve_deep": lambda: unpack_device._resolve_deep(*args, **kw),
        "hrt1_encode": lambda: encode_sup._launch(xd, tl, None, cap, 6)})
    kt.update(cuda_ms({
        "decode_plain": lambda: decode_sup.decode_columns_plain(
            *dargs, block_size=B, out_words=True),
        "resolve_plain": lambda: unpack_device.resolve_deep_plain(*args, **kw),
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
        "hrt1_resolve_deep": bound(nbytes(*args, *rk), rk[0].numel()),
        # x read once; literal rows and fixed-capacity columns written once
        "hrt1_encode": bound(2 * nb_ * B + 9 * nb_ * cap + 12 * nb_,
                             nb_ * B),
    }
    gb = len(dct) / 1e9
    for k, p in (("hrt1_decode", "decode_plain"),
                 ("hrt1_resolve_deep", "resolve_plain"),
                 ("hrt1_encode", "encode_plain")):
        log(f"[{card}] {k}: device {kt[k]:.4f} ms ({gb / kt[k] * 1e3:.2f} "
            f"GB/s of {len(dct) >> 20} MiB DCT, {nb_} blocks), bound "
            f"{bounds[k][0]:.4f} ms by {bounds[k][1]} = "
            f"{100 * bounds[k][0] / kt[k]:.1f}% of it; plain {kt[p]:.4f} ms")
    log(f"[{card}] CUDA events over back-to-back calls: hrt1_decode wrapper "
        f"{ev['hrt1_decode']:.4f} ms, hrt1_encode launch "
        f"{ev['hrt1_encode']:.4f} ms, checked wrapper "
        f"{ev['encode_checked']:.4f} ms")
    for name in ("dct64", "dct64_flat"):
        b, raw = rows[name]
        p = container.pack_for_device(b)
        a = unpack_device.ship_packed(p, dev)
        dt = cuda_ms({
            "kernels": lambda: unpack_device.dispatch_packed(
                p, a, out_words=True),
            "plain": lambda: plain_dispatch(p, a)})
        log(f"[{card}] dispatch_packed {name}: kernels {dt['kernels']:.4f} "
            f"ms = {len(raw) / 1e6 / dt['kernels']:.2f} GB/s, plain "
            f"{dt['plain']:.4f} ms = {len(raw) / 1e6 / dt['plain']:.2f} GB/s")
    for name in ("dct64", "dct16_w32"):
        b, raw = rows[name]
        w = best_wall(lambda: api.decompress(b, device=dev))
        log(f"[{card}] decompress wall ({name}, host pack + copies + "
            f"kernels + device re-interleave + D2H): {w * 1e3:.1f} ms best "
            f"of 3 = {len(raw) / 1e9 / w:.3f} GB/s")
    split = compress_split(dct, dev)
    wk = best_wall(lambda: api.compress(dct, "8 Bit", backend="kernel",
                                        device=dev))
    wn = best_wall(lambda: api.compress(dct, "8 Bit", backend="native",
                                        device="cpu"))
    log(f"[{card}] compress wall (64 MiB DCT, 8 Bit), best of 3: stages "
        + " | ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f" ms; api.compress kernel {wk * 1e3:.1f} ms, native "
        f"{wn * 1e3:.1f} ms")

    errs = {"hrt1_decode": err_k1, "hrt1_resolve_deep": err_k2,
            "hrt1_encode": err_k3}
    times = {k: (kt[k], kt[p], None) for k, p in (
        ("hrt1_decode", "decode_plain"), ("hrt1_resolve_deep", "resolve_plain"),
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
    fuzz_phase(dev, card)

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
