#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (needs a Hopper card).

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. card: torch must see a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles the Hopper kernels from csrc/*.cu with nvcc.
3. kernels vs plain: hrt1_decode on synthetic columns (dense, sparse,
   all-literal, whole-block run, ragged tail, zero-count commands mid-stream,
   min_count 1; 4 KiB, 64 KiB and 256 KiB blocks) and hrt1_resolve_deep on
   the deep sections of a real container, each byte-equal to its plain
   torch version on the same card tensors.
4. main path: api.compress -> api.decompress(device="cuda") on the 64 MiB
   DCT corpus (deep + litdict), its flat layout, the random and bwt rows and
   the 32-bit codec; the output must equal the input, and both kernels'
   launch counters must move during these decompresses.
5. times: CUDA-event medians of each kernel and of dispatch_packed on
   shipped sections (deep and flat) beside the plain versions on the same
   card, and the wall time of one whole decompress.

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
from hypersonic_rle_kit_tpu_torch.ops import (_kernels, decode_sup, planar,
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

def synthetic_columns(kind: str, B: int, nb: int, seed: int):
    """Planar columns of one edge case, numpy, lits trimmed to int32 words
    the way container.pack_for_device trims them."""
    rng = np.random.default_rng(seed)
    lens = np.full(nb, B, np.int32)
    min_count = 6
    if kind == "zero_count_mid":
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
        if kind == "dense":
            x = np.repeat(rng.integers(0, 251, (nb, B // 6 + 1)), 6,
                          axis=1)[:, :B].astype(np.uint8)
        elif kind in ("sparse", "ragged_tail"):
            x = bench.make_dataset(max(1, nb * B // MIB), seed=seed)
            x = x[:nb * B].reshape(nb, B).copy()
            if kind == "ragged_tail":
                lens[-3:] = [B - 777, 17, 0]
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

    # ---- inputs of the main path ----
    t0 = time.perf_counter()
    dct = bench.make_dataset(64).tobytes()
    blob = api.compress(dct, "8 Bit", backend="native")
    info, _ = container.parse(blob)
    if not (info.deep and info.litdict and info.block_size == 1 << 18):
        raise AssertionError(f"DCT container is not deep+litdict: {info}")
    B = info.block_size
    x, lens = api._to_blocks(np.frombuffer(dct, np.uint8), B)
    cols = native.planar_from_bytes(x, lens, planar.capacity_for(B, 6), 6)
    flat = container.serialize_blocks(0, len(dct), B, 6, *cols, deep=False)
    rows = {"dct64_deep_litdict": (blob, dct), "dct64_flat": (flat, dct)}
    for name, raw, codec in (
            ("random16", bench.make_random_dataset(16).tobytes(), "8 Bit"),
            ("bwt16", bench.make_bwt_dataset(16).tobytes(), "8 Bit"),
            ("dct16_w32", bench.make_dataset(16).tobytes(),
             "32 Bit (Symbol)")):
        rows[name] = (api.compress(raw, codec, backend="native"), raw)
    for name, (b, raw) in rows.items():
        i, _ = container.parse(b)
        log(f"  input {name}: {len(raw)} B -> {len(b)} B "
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

    # ---- 4. main path ----
    api.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    outs = {name: api.decompress(b, device=dev)
            for name, (b, raw) in rows.items()}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = api.kernel_launch_counts()
    for name, (b, raw) in rows.items():
        if outs[name] != raw:
            raise AssertionError(f"decompress({name}) != input")
    log(f"main path: {len(rows)} round trips equal their input "
        f"({main_s:.2f} s of decompress); launches {launches}")
    for k in KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"{k} never launched on the main path")

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
    for name in ("dct64_deep_litdict", "dct64_flat"):
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
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        api.decompress(blob, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[{card}] decompress wall (64 MiB DCT deep+litdict, host pack + "
        f"copies + kernels + D2H): {min(walls) * 1e3:.1f} ms best of 3 = "
        f"{len(dct) / 1e9 / min(walls):.3f} GB/s")

    errs = {"hrt1_decode": err_k1, "hrt1_resolve_deep": err_k2}
    plain = {"hrt1_decode": "decode_plain",
             "hrt1_resolve_deep": "resolve_plain"}
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
