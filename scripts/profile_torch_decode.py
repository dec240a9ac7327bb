#!/usr/bin/env python3
"""Where the time of the port's HRT1 decompress goes, on one CUDA card.

    python3 scripts/profile_torch_decode.py [--mib 64] [--iters 20] [--out F]

For the DCT corpus (datasets.make_dataset) in its auto-picked layout (deep +
literal dictionary) and in the flat layout:

- torch.profiler over ``iters`` calls of ``dispatch_packed`` on shipped
  sections: device time by op (CUDA kernels and the torch ops around
  them), kernel launches per call, and the device's busy share of the
  window;
- one ``api.decompress`` split into its stages (parse + pack on the host,
  H2D, device decode, D2H into a pinned buffer, host slice), each closed
  by a synchronize.

Prints a summary on stdout; ``--out F`` also writes the full op tables to F.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hypersonic_rle_kit_tpu_torch import api, datasets  # noqa: E402
from hypersonic_rle_kit_tpu_torch.ops import planar, unpack_device  # noqa: E402
from hypersonic_rle_kit_tpu_torch.parallel import container  # noqa: E402
from hypersonic_rle_kit_tpu_torch.utils import native  # noqa: E402


def _dev_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


def profile_dispatch(name, blob, dev, iters) -> str:
    """Profile ``iters`` dispatches; prints a summary, returns the table."""
    pk = container.pack_for_device(blob)
    arrs = unpack_device.ship_packed(pk, dev)
    for _ in range(3):
        unpack_device.dispatch_packed(pk, arrs, out_words=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            unpack_device.dispatch_packed(pk, arrs, out_words=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_evts = [e for e in ka if _dev_us(e) > 0]
    busy = sum(_dev_us(e) for e in dev_evts) / 1e6
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    key = ("self_device_time_total" if ka and hasattr(
        ka[0], "self_device_time_total") else "self_cuda_time_total")
    top = sorted(dev_evts, key=_dev_us, reverse=True)[:8]
    print(f"{name}: {wall / iters * 1e3:.3f} ms per call (host clock), "
          f"device busy {busy / iters * 1e3:.3f} ms = "
          f"{100 * busy / wall:.1f}% of the window, "
          f"{len(kernels) / iters:.0f} device ops per call")
    for e in top:
        print(f"   {_dev_us(e) / iters / 1e3:8.4f} ms/call  "
              f"{e.count // iters:4d}x  {e.key[:70]}")
    return (f"== {name}: dispatch_packed x{iters}\n"
            + ka.table(sort_by=key, row_limit=40) + "\n")


def stage_split(name, blob, raw, dev):
    times = []
    for _ in range(3):
        t = [time.perf_counter()]
        info, blocks = container.parse(blob)
        pk = container.pack_for_device(blob, parsed=(info, blocks))
        t.append(time.perf_counter())
        arrs = unpack_device.ship_packed(pk, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        yd, bad = unpack_device.dispatch_packed(pk, arrs, with_flags=True,
                                                out_words=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        assert bad is None or not bool(bad.any())
        y = api._to_host_bytes(yd, words=True)
        t.append(time.perf_counter())
        got = y.reshape(-1)[:info.uncompressed_size].tobytes()
        t.append(time.perf_counter())
        assert got == raw
        times.append(np.diff(t) * 1e3)
    best = np.min(np.array(times), axis=0)
    t0 = time.perf_counter()
    api.decompress(blob, device=dev)
    whole = (time.perf_counter() - t0) * 1e3
    print(f"{name}: decompress stages, best of 3 (ms): parse+pack "
          f"{best[0]:.2f} | H2D {best[1]:.2f} | device decode {best[2]:.2f}"
          f" | D2H {best[3]:.2f} | host slice {best[4]:.2f} | api.decompress"
          f" {whole:.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="file for the full profiler op tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    raw = datasets.make_dataset(args.mib).tobytes()
    deep = api.compress(raw, "8 Bit", backend="native", device="cpu")
    B = container.DEFAULT_BLOCK_SIZE
    x, lens = api._to_blocks(np.frombuffer(raw, np.uint8), B)
    cols = native.planar_from_bytes(x, lens, planar.capacity_for(B, 6), 6)
    flat = container.serialize_blocks(0, len(raw), B, 6, *cols, deep=False)
    tables = [f"card: {card}\n"]
    for name, blob in ((f"dct{args.mib}_deep_litdict", deep),
                       (f"dct{args.mib}_flat", flat)):
        tables.append(profile_dispatch(name, blob, dev, args.iters))
        stage_split(name, blob, raw, dev)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
