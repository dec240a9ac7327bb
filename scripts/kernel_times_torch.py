#!/usr/bin/env python3
"""CUDA-event times of the HRT1 codec kernels on the main path's shapes,
for one or more checkouts of the repository on the same card.

    python3 scripts/kernel_times_torch.py [--roots DIR ...] [--out FILE]

Inputs, made once by this checkout (``datasets.make_dataset``, seeded):
the 64 MiB DCT corpus in 256 KiB blocks and the Low Entropy stream of its
first 4 MiB (one subsection, so one 4 MiB block).  Each root (default:
this checkout) is timed in a fresh interpreter that imports that root's
``hypersonic_rle_kit_tpu_torch``, in the order given, so a parent and a
change compare within one call (pass ``PARENT . . PARENT``).  Per root:

- ``hrt1_encode``: the kernel wrapper's launch (``encode_sup._launch``)
  on the 256 blocks;
- ``hrt1_decode``: ``decode_columns_device`` on the deep container's
  resolved columns (words out);
- ``dispatch_deep`` / ``dispatch_flat``: ``unpack_device.dispatch_packed``
  on the shipped sections of the deep + litdict and the flat container;
- ``le1_decode``: ``decode_columns_device`` on the one-block LE columns;

the kernels as the device time of one call (10 calls captured in a CUDA
graph, its replays timed with CUDA events: no host work), and all five as
the CUDA-event median of 11 samples of 10 back-to-back calls (host work
of the wrappers included), after a warm-up; each kernel output held
against its plain version (max |error|).  Prints one JSON line per root, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
MIB = 1 << 20


def make_inputs(d: pathlib.Path) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from hypersonic_rle_kit_tpu_torch import api, datasets
    from hypersonic_rle_kit_tpu_torch.formats import low_entropy
    from hypersonic_rle_kit_tpu_torch.ops import planar
    from hypersonic_rle_kit_tpu_torch.parallel import container
    from hypersonic_rle_kit_tpu_torch.utils import native

    raw = datasets.make_dataset(64).tobytes()
    (d / "dct64.bin").write_bytes(raw)
    B = container.DEFAULT_BLOCK_SIZE
    x, lens = api._to_blocks(np.frombuffer(raw, np.uint8), B)
    cols = native.planar_from_bytes(x, lens, planar.capacity_for(B, 6), 6)
    (d / "dct64_flat.hrt1").write_bytes(
        container.serialize_blocks(0, len(raw), B, 6, *cols, deep=False))
    (d / "dct64_deep.hrt1").write_bytes(
        api.compress(raw, "8 Bit", backend="native", device="cpu"))
    (d / "le4.bin").write_bytes(low_entropy.le_compress(raw[:4 * MIB]))


def cuda_ms(fns: dict, reps: int = 11, calls: int = 10) -> dict:
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for r in range(reps):
        for k in (list(fns) if r % 2 == 0 else list(reversed(fns))):
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
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    its replays timed with CUDA events (median), host work not counted."""
    import torch
    out = {}
    cur = torch.cuda.current_stream()
    for k, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
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
    return out


def time_root(root: str, d: pathlib.Path) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from hypersonic_rle_kit_tpu_torch import api
    from hypersonic_rle_kit_tpu_torch.ops import (decode_sup, device,
                                                  encode_sup,
                                                  low_entropy_device, planar,
                                                  transfer, unpack_device)

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times_torch: no CUDA device")
    dev = torch.device("cuda")
    raw = (d / "dct64.bin").read_bytes()
    B = 1 << 18
    x, lens = api._to_blocks(np.frombuffer(raw, np.uint8), B)
    xd, tl = transfer.to_device(x, dev), transfer.to_device(lens, dev)
    cap = planar.capacity_for(B, 6)

    def err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    errs = {}
    ek = encode_sup._launch(xd, tl, None, cap, 6)
    pb = device.encode_blocks(xd, tl, capacity=cap, min_count=6)
    errs["hrt1_encode"] = max(err(a, b) for a, b in zip(ek, (
        pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)))
    del pb, ek

    packs = {}
    for name in ("deep", "flat"):
        pk = api.container.pack_for_device(
            (d / f"dct64_{name}.hrt1").read_bytes())
        packs[name] = (pk, unpack_device.ship_packed(pk, dev))
    pk, arrs = packs["deep"]
    planes, kw = _deep_args(pk, arrs, unpack_device)
    cnt, ll, sym = unpack_device._resolve_deep(*planes, **kw)
    dargs = (sym, cnt, ll, arrs["lits"], arrs["n_cmds"], arrs["n_lits"],
             arrs["block_len"])
    errs["hrt1_decode"] = err(
        decode_sup.decode_columns_device(*dargs, block_size=B,
                                         out_words=True),
        decode_sup.decode_columns_plain(*dargs, block_size=B, out_words=True))
    le_cols, le_B, _ = low_entropy_device.walk_le((d / "le4.bin").read_bytes())
    le = decode_sup.columns_to_device(le_cols, dev)
    errs["le1_decode"] = err(
        decode_sup.decode_columns_device(*le, block_size=le_B),
        decode_sup.decode_columns_plain(*le, block_size=le_B))
    kernels = {
        "hrt1_encode": lambda: encode_sup._launch(xd, tl, None, cap, 6),
        "hrt1_decode": lambda: decode_sup.decode_columns_device(
            *dargs, block_size=B, out_words=True),
        "le1_decode": lambda: decode_sup.decode_columns_device(
            *le, block_size=le_B),
    }
    dispatch = {
        "dispatch_deep": lambda: unpack_device.dispatch_packed(
            *packs["deep"], out_words=True),
        "dispatch_flat": lambda: unpack_device.dispatch_packed(
            *packs["flat"], out_words=True),
    }
    return dict(root=root, device_ms=graph_ms(kernels),
                event_ms=cuda_ms({**kernels, **dispatch}),
                max_abs_err=errs,
                shapes=dict(encode=list(x.shape), le_block=le_B,
                            le_cmds=int(le_cols[4][0])))


def _deep_args(pk, arrs, unpack_device):
    cap = pk["capacity"]
    planes = [unpack_device._unpack_wide(arrs[k], bits, cap) for k, bits in (
        ("cnts_raw", pk["cnt_bits"]), ("cnt_ovf_raw", pk["cnt_ovf_bits"]),
        ("lls_raw", pk["lit_bits"]), ("ll_ovf_raw", pk["ll_ovf_bits"]),
        ("lut_raw", 3))]
    kw = dict(cap=cap, cnt_bits=pk["cnt_bits"] if pk["cnt_ovf_bits"] else 0,
              lit_bits=pk["lit_bits"] if pk["ll_ovf_bits"] else 0,
              min_count=pk["info"].min_count)
    return (*planes, arrs["miss_raw"], arrs["dict7"], arrs["n_cmds"]), kw


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[str(ROOT)])
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        print(json.dumps(time_root(args.root, pathlib.Path(args.data))),
              flush=True)
        return 0
    lines = []
    with tempfile.TemporaryDirectory() as td:
        make_inputs(pathlib.Path(td))
        for r in args.roots:
            res = subprocess.run(
                [sys.executable, __file__, "--root",
                 str(pathlib.Path(r).resolve()), "--data", td],
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                sys.stderr.write(res.stdout + res.stderr)
                raise SystemExit(f"timing {r} failed: {res.returncode}")
            lines.append(res.stdout.strip().splitlines()[-1])
            print(lines[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(lines + [card]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
