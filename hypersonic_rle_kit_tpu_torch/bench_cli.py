"""Benchmark / validation CLI of the port (the analog of the reference's
`hsrlekit`, main.c:94-1094).

Usage:
    python -m hypersonic_rle_kit_tpu_torch.bench_cli <file> --device D
        [options]

The options are those of ``python -m hypersonic_rle_kit_tpu.bench_cli``
(its row filter, timing loop, row printer and ``--analyze`` are copied
here), plus ``--device`` ('cuda' or 'cpu', required): the reference-format rows
run the shared host codecs, and ``--hrt1`` adds HRT1 container rows
through the port, ``api.compress(backend="kernel", device=D)`` (the
hrt1_encode kernel on CUDA) and ``api.decompress(device=D)`` (hrt1_decode,
hrt1_unpack_resolve).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import api, spec as spec_mod
from .formats import registry


def shannon_entropy_ratio(buf: bytes) -> float:
    """Normalized Shannon entropy of `buf` (GetInformationRatio,
    main.c:1221-1244): what an entropy coder could shrink it to."""
    if not buf:
        return 0.0
    counts = np.bincount(np.frombuffer(buf, np.uint8), minlength=256)
    p = counts[counts > 0] / len(buf)
    bits = -(p * np.log2(p)).sum()
    return bits / 8.0


def matches(s: spec_mod.CodecSpec, args) -> bool:
    """CodecMatchesArgs (main.c:1690+)."""
    if args.codec:
        return s.name in args.codec
    F = spec_mod.Family
    fam_filters = {
        "extreme": (F.RLE8, F.RLEX, F.LUT, F.SHORT),
        "low_entropy": (F.LOW_ENTROPY, F.LOW_ENTROPY_SHORT),
        "sh": (F.SH,),
        "mmtf": (F.MMTF, F.BIT_MMTF),
        "rle_mmtf": (F.RLE8_MMTF,),
    }
    chosen = [fams for k, fams in fam_filters.items() if getattr(args, k)]
    if chosen and not any(s.family in fams for fams in chosen):
        return False
    if s.family is F.MEMCPY:
        return not chosen
    if args.x_size and s.width != args.x_size:
        return False
    if args.lut_size is not None and s.lut != args.lut_size:
        return False
    if args.byte and not s.byte_aligned:
        return False
    if args.symbol_aligned and s.byte_aligned:
        return False
    if args.packed and not s.packed:
        return False
    if args.short and not s.short:
        return False
    if args.single and not s.single:
        return False
    if args.multi and s.single:
        return False
    if args.greedy and not s.greedy:
        return False
    return True


def analyze(data: bytes) -> None:
    """Run-length statistics by symbol width (AnalyzeData, main.c:1246+)."""
    arr = np.frombuffer(data, np.uint8)
    print(f"{'width':>6} | {'runs>=min':>10} | {'avg run':>8} | "
          f"{'run cover %':>11} | {'distinct syms':>13}")
    for width in (1, 2, 3, 4, 6, 8, 16):
        n = arr.size // width * width
        v = arr[:n].reshape(-1, width)
        eq = (v[1:] == v[:-1]).all(axis=1)
        change = np.flatnonzero(~eq) + 1
        starts = np.concatenate(([0], change))
        lengths = (np.concatenate((change, [v.shape[0]])) - starts) * width
        keep = lengths >= max(2 * width, 4)
        cover = lengths[keep].sum() / max(n, 1) * 100
        avg = lengths[keep].mean() if keep.any() else 0.0
        distinct = len(np.unique(v[starts[keep]], axis=0)) if keep.any() else 0
        print(f"{width*8:>6} | {int(keep.sum()):>10} | {avg:>8.1f} | "
              f"{cover:>10.1f}% | {distinct:>13}")


def timed_loop(fn, runs: int, min_time: float, test_mode: bool):
    """Reference timing discipline (main.c:825-905): one dry run, then
    timed repetitions until both ``runs`` samples and ``min_time`` seconds
    are reached, with a 100 ms cooldown sleep every 10 runs.  Returns
    (result, avg_s, min_s, stddev_s)."""
    t0 = time.perf_counter()
    result = fn()
    dry = time.perf_counter() - t0
    if test_mode:                       # --test skips the timing loop
        return result, dry, dry, 0.0
    samples = [dry]
    total = dry
    while len(samples) < runs or total < min_time:
        if len(samples) % 10 == 0:
            time.sleep(0.1)             # cooldown (main.c:869)
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        samples.append(dt)
        total += dt
        if total > max(min_time * 4, 10.0):   # runaway guard
            break
    arr = np.asarray(samples)
    return result, float(arr.mean()), float(arr.min()), float(arr.std())


def _row(name, data, mib, comp_fn, dec_fn, args):
    comp, e_avg, e_min, e_sd = timed_loop(
        lambda: comp_fn(data), args.runs, args.min_time, args.test)
    dec, d_avg, d_min, d_sd = timed_loop(
        lambda: dec_fn(comp), args.runs, args.min_time, args.test)
    ok = dec == data
    ratio = len(comp) / max(len(data), 1) * 100
    ent = shannon_entropy_ratio(comp) * ratio
    status = "" if ok else "  [FAILED]"
    print(f"{name:<31}| {ratio:6.2f} % | {mib/e_avg:8.1f} "
          f"({mib/e_min:8.1f} ± {mib/e_avg**2*e_sd:6.1f}) "
          f"| {mib/d_avg:8.1f} ({mib/d_min:8.1f} ± {mib/d_avg**2*d_sd:6.1f}) "
          f"| {ent:6.2f} %{status}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hsrlekit-torch")
    ap.add_argument("file")
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"),
                    help="where the HRT1 rows compress and decompress")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--min-time", type=float, default=0.5)
    ap.add_argument("--max", type=float, default=None, help="truncate to MiB")
    for f in ("extreme", "low-entropy", "sh", "mmtf", "rle-mmtf", "byte",
              "symbol-aligned", "packed", "short", "single", "multi",
              "greedy", "analyze"):
        ap.add_argument(f"--{f}", action="store_true")
    ap.add_argument("--x-size", type=int, default=None)
    ap.add_argument("--lut-size", type=int, default=None)
    ap.add_argument("--codec", action="append", default=None)
    ap.add_argument("--tier", choices=("auto", "python"), default="auto",
                    help="force the host implementation tier: 'python' "
                         "disables the native runtime")
    ap.add_argument("--hrt1", action="store_true",
                    help="add HRT1 container rows through the port on "
                         "--device")
    args = ap.parse_args(argv)

    if args.tier == "python":
        from .utils import native
        native.disable()

    with open(args.file, "rb") as f:
        data = f.read()
    if args.max:
        data = data[: int(args.max * (1 << 20))]
    mib = len(data) / (1 << 20)
    print(f"{args.file}: {len(data)} bytes ({mib:.2f} MiB), "
          f"tier={args.tier}, device={args.device}", file=sys.stderr)

    if args.analyze:
        analyze(data)
        return 0

    print(f"{'Codec':<31}| Ratio    | Encoder avg (max ± sd) MiB/s "
          f"| Decoder avg (max ± sd) MiB/s | Compressible To")
    failed = False
    for s in spec_mod.REGISTRY:
        if not matches(s, args):
            continue
        try:
            failed |= not _row(s.name, data, mib,
                               lambda d, s=s: registry.compress(d, s),
                               lambda c, s=s: registry.decompress(c, s),
                               args)
        except Exception as e:  # noqa: BLE001 - one row fails, not the run
            failed = True
            print(f"{s.name:<31}| ERROR: {e}")
    if args.hrt1:
        for cname in (args.codec or ["8 Bit", "32 Bit (Symbol)"]):
            try:
                failed |= not _row(
                    f"HRT1 {cname}", data, mib,
                    lambda d, c=cname: api.compress(
                        d, c, backend="kernel", device=args.device),
                    lambda b: api.decompress(b, device=args.device), args)
            except Exception as e:  # noqa: BLE001
                failed = True
                print(f"HRT1 {cname:<26}| ERROR: {e}")
    return 1 if (args.test and failed) else 0


if __name__ == "__main__":
    sys.exit(main())
