"""Benchmark / validation CLI of the port (the analog of the reference's
`hsrlekit`, main.c:94-1094).

Usage:
    python -m hypersonic_rle_kit_tpu_torch.bench_cli <file> --device D
        [options]

The options are those of ``python -m hypersonic_rle_kit_tpu.bench_cli``
(whose row filter, timing loop, row printer and ``--analyze`` are shared),
plus ``--device`` ('cuda' or 'cpu', required): the reference-format rows
run the shared host codecs, and ``--hrt1`` adds HRT1 container rows
through the port, ``api.compress(backend="kernel", device=D)`` (the
hrt1_encode kernel on CUDA) and ``api.decompress(device=D)`` (hrt1_decode,
hrt1_resolve_deep).
"""

from __future__ import annotations

import argparse
import sys

from hypersonic_rle_kit_tpu import spec as spec_mod
from hypersonic_rle_kit_tpu.bench_cli import _row, analyze, matches
from hypersonic_rle_kit_tpu.formats import registry

from . import api


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
        from hypersonic_rle_kit_tpu.utils import native
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
