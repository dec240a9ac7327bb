#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (needs a Hopper card).

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. card: torch must see a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles the Hopper kernels from csrc/*.cu with nvcc, one
   process per source, all started together.
3. kernels vs plain: hrt1_decode on synthetic columns (dense, sparse,
   all-literal, whole-block run, ragged tail, zero-count commands mid-stream,
   min_count 1; 4 KiB, 64 KiB and 256 KiB blocks), hrt1_resolve_deep on
   the deep sections of a real container, and hrt1_encode on synthetic
   blocks (dense, sparse DCT, all-literal, whole-block run, ragged tail,
   Single, min_count 1 and 4; 4 KiB, 64 KiB, 192 KiB and 256 KiB blocks),
   each byte-equal to its plain torch version on the same card tensors.
4. main paths.  Compress: api.compress(backend="kernel", device="cuda") on
   the 64 MiB DCT corpus ("8 Bit" and "8 Bit Single"), the random and bwt
   rows, "32 Bit (Symbol)" and "24 Bit (Symbol)" on 16 MiB + 1001 bytes
   must equal backend="native" byte for byte, and hrt1_encode's launch
   counter must move.  Decompress: api.decompress(device="cuda") of those
   blobs and of the 64 MiB corpus's flat layout must equal the input, and
   both decode kernels' launch counters must move.  Each path's counters
   are set to 0 just before it and read just after.
5. times: CUDA-event medians of each kernel and of dispatch_packed on
   shipped sections (deep and flat) beside the plain versions on the same
   card; the wall time of one whole decompress (64 MiB DCT, and the 32-bit
   width row with the device re-interleave); the compress wall of the
   64 MiB DCT corpus split into its stages.

The line before the last is one JSON object with each kernel's route,
source, replaced TPU kernel, launches, max |error| and times; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import bench
from hypersonic_rle_kit_tpu.parallel import container
from hypersonic_rle_kit_tpu.utils import native
from hypersonic_rle_kit_tpu_torch import api
from hypersonic_rle_kit_tpu_torch.ops import (_kernels, decode_sup, device,
                                              encode_sup, planar,
                                              unpack_device)

MIB = 1 << 20
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
}


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
        x = bench.make_dataset(-(-nb * B // MIB), seed=seed)
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
    lw = max(128, -(-int(cols[5].max()) // 128) * 128)
    cols[3] = decode_sup.lits_to_words(
        np.ascontiguousarray(cols[3][:, :min(lw, B)]))
    return cols + [lens]


def check_decode_cases(dev) -> int:
    worst = 0
    kinds = ("dense", "sparse", "all_literal", "whole_run", "ragged_tail",
             "zero_count_mid", "min_count_1")
    for B in (4096, 65536, 262144):
        for i, kind in enumerate(kinds):
            cols = synthetic_columns(kind, B, 8, seed=i + 1)
            t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in cols]
            for words in (True, False):
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
             "single", "min_count_1", "min_count_4")
    for B in (4096, 65536, 196608, 262144):
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
        xd, tl = api._to_device(x, dev), api._to_device(lens, dev)
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
    if blob != api.compress(raw, "8 Bit", backend="native"):
        raise AssertionError("compress stages != native compress")
    return dict(zip(("to_blocks_h2d", "encode", "d2h", "serialize"),
                    best.tolist()))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _kernels.build()
    _kernels.lib()
    log(f"build: nvcc {' '.join(_kernels.NVCC_FLAGS)} -> "
        f"{_kernels.library_path().name} in {time.perf_counter() - t0:.2f} s")

    # ---- inputs of the main paths: (raw, codec) and native blobs ----
    t0 = time.perf_counter()
    dct = bench.make_dataset(64).tobytes()
    dct16 = bench.make_dataset(17)[:16 * MIB + 1001].tobytes()
    crows = {"dct64": (dct, "8 Bit"),
             "dct64_single": (dct, "8 Bit Single"),
             "random16": (bench.make_random_dataset(16).tobytes(), "8 Bit"),
             "bwt16": (bench.make_bwt_dataset(16).tobytes(), "8 Bit"),
             "dct16_w32": (dct16[:16 * MIB], "32 Bit (Symbol)"),
             "dct16p_w24": (dct16, "24 Bit (Symbol)")}
    native_blobs = {name: api.compress(raw, codec, backend="native")
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
    cap = planar.capacity_for(B, 6)
    xd, tl = api._to_device(x, dev), api._to_device(lens, dev)
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
    for k in KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"{k} never launched on the main path")
    del outs

    # ---- 5. times ----
    kt = cuda_ms({
        "hrt1_decode": lambda: decode_sup.decode_columns_device(
            *dargs, block_size=B, out_words=True),
        "decode_plain": lambda: decode_sup.decode_columns_plain(
            *dargs, block_size=B, out_words=True),
        "hrt1_resolve_deep": lambda: unpack_device._resolve_deep(*args, **kw),
        "resolve_plain": lambda: unpack_device.resolve_deep_plain(*args, **kw),
    })
    gb = len(dct) / 1e9
    log(f"[{card}] hrt1_decode {kt['hrt1_decode']:.4f} ms "
        f"({gb / kt['hrt1_decode'] * 1e3:.2f} GB/s decoded) vs plain "
        f"{kt['decode_plain']:.4f} ms; hrt1_resolve_deep "
        f"{kt['hrt1_resolve_deep']:.4f} ms vs plain "
        f"{kt['resolve_plain']:.4f} ms ({len(dct) >> 20} MiB DCT, "
        f"{pk['info'].n_blocks} blocks)")
    # the kernel alone (no capacity check), the checked wrapper (one
    # synchronisation per call) and the plain encoder (one per call too)
    kt.update(cuda_ms({
        "hrt1_encode": lambda: encode_sup._launch(xd, tl, None, cap, 6),
        "encode_checked": lambda: encode_sup.encode_blocks_kernel(
            xd, tl, capacity=cap, min_count=6),
        "encode_plain": lambda: device.encode_blocks(
            xd, tl, capacity=cap, min_count=6),
    }, reps=5, calls=4))
    log(f"[{card}] hrt1_encode {kt['hrt1_encode']:.4f} ms "
        f"({gb / kt['hrt1_encode'] * 1e3:.2f} GB/s encoded), checked "
        f"wrapper {kt['encode_checked']:.4f} ms, plain "
        f"{kt['encode_plain']:.4f} ms ({len(dct) >> 20} MiB DCT, "
        f"{x.shape[0]} blocks)")
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
    wn = best_wall(lambda: api.compress(dct, "8 Bit", backend="native"))
    log(f"[{card}] compress wall (64 MiB DCT, 8 Bit), best of 3: stages "
        + " | ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f" ms; api.compress kernel {wk * 1e3:.1f} ms, native "
        f"{wn * 1e3:.1f} ms")

    errs = {"hrt1_decode": err_k1, "hrt1_resolve_deep": err_k2,
            "hrt1_encode": err_k3}
    plain = {"hrt1_decode": "decode_plain",
             "hrt1_resolve_deep": "resolve_plain",
             "hrt1_encode": "encode_plain"}
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        dict(name=k, **meta, launches=launches[k], max_abs_err=errs[k],
             ms=kt[k], plain_ms=kt[plain[k]])
        for k, meta in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
