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
- ``k2_deep`` / ``k2_flat``: the column-prep kernel on the shipped
  sections of the deep + litdict and the flat container:
  ``unpack_resolve`` (hrt1_unpack_resolve) where the root has it, else
  the resolver alone (``_resolve_deep`` on planes unpacked beforehand;
  such a root has no flat kernel);
- ``dispatch_deep`` / ``dispatch_flat``: ``unpack_device.dispatch_packed``
  on the shipped sections of those containers, with its device operations
  per call (``ops_per_call``: the nodes of a captured CUDA graph);
- ``le1_decode``: ``decode_columns_device`` on the one-block LE columns;
- ``mmtf_{dct,rand}_{enc,dec}``: ``mmtf_device.mmtf_scan`` (16 lanes, one
  block) on 1 MiB of the DCT corpus and 1 MiB of ``default_rng(0)``
  uniform bytes, encoding them and decoding their MMTF 128 encoding;

the kernels and the dispatches as the device time of one call (10 calls
captured in a CUDA graph, its replays timed with CUDA events: no host
work), and all but the MMTF scans as the CUDA-event median of 11 samples
of 10 back-to-back calls (host work of the wrappers included), after a
warm-up; each kernel output held against its plain version (max |error|),
the MMTF scans against the host format (``formats.mmtf``).  Prints one JSON line per root, then the
card's name and power limit.

``--mmtf-chunks C ...`` also times ``mmtf_scan``'s kernel at each chunk
length C on the four MMTF inputs (roots whose wrapper takes a chunk
length) and fits T(C) = a * C * ceil(K / SMs) + b * K + c by least
squares, K = ceil(U / C) chunks of U units per lane (one CTA each): a is
the chunk pass's step with one CTA of 16 warps per SM (its SMs run
ceil(K / SMs) CTAs in turn, or side by side at the same issue rate), b the
carry's step, c the rest (fix-up, launches).  It prints the three phases'
times at the wrapper's own chunk length.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
MIB = 1 << 20


def make_inputs(d: pathlib.Path) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from hypersonic_rle_kit_tpu_torch import api, datasets
    from hypersonic_rle_kit_tpu_torch.formats import low_entropy, mmtf
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
    streams = {"dct": raw[:MIB],
               "rand": np.random.default_rng(0).integers(
                   0, 256, MIB, dtype=np.uint8).tobytes()}
    for name, data in streams.items():
        (d / f"mmtf_{name}.bin").write_bytes(data)
        (d / f"mmtf_{name}.enc").write_bytes(mmtf._mmtf(data, 16, encode=True))


def _timing():
    """This checkout's CUDA timing helpers (``utils/cuda_timing.py``),
    loaded by path: the package a root's interpreter imports is that
    root's, which may predate them."""
    path = ROOT / "hypersonic_rle_kit_tpu_torch" / "utils" / "cuda_timing.py"
    spec = importlib.util.spec_from_file_location("cuda_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_root(root: str, d: pathlib.Path, chunks: list[int]) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from hypersonic_rle_kit_tpu_torch import api
    from hypersonic_rle_kit_tpu_torch.ops import (decode_sup, device,
                                                  encode_sup,
                                                  low_entropy_device,
                                                  mmtf_device, planar,
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
    if hasattr(unpack_device, "unpack_resolve"):
        args, kw = unpack_device.section_args(*packs["deep"])
        fargs, fkw = unpack_device.section_args(*packs["flat"])
        cnt, ll, sym, _ = unpack_device.unpack_resolve(*args, **kw)
        errs["k2_deep"] = max(err(a, b) for a, b in zip(
            unpack_device.unpack_resolve(*args, **kw),
            unpack_device.unpack_resolve_plain(*args, **kw)))
        errs["k2_flat"] = max(err(a, b) for a, b in zip(
            unpack_device.unpack_resolve(*fargs, **fkw)[:2],
            unpack_device.unpack_resolve_plain(*fargs, **fkw)[:2]))
        k2 = {"k2_deep": lambda: unpack_device.unpack_resolve(*args, **kw),
              "k2_flat": lambda: unpack_device.unpack_resolve(*fargs, **fkw)}
    else:   # a root from before hrt1_unpack_resolve: the resolver alone
        planes, kw = _deep_args(pk, arrs, unpack_device)
        cnt, ll, sym = unpack_device._resolve_deep(*planes, **kw)
        errs["k2_deep"] = max(err(a, b) for a, b in zip(
            unpack_device._resolve_deep(*planes, **kw),
            unpack_device.resolve_deep_plain(*planes, **kw)))
        k2 = {"k2_deep": lambda: unpack_device._resolve_deep(*planes, **kw)}
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
        **k2,
        "hrt1_encode": lambda: encode_sup._launch(xd, tl, None, cap, 6),
        "hrt1_decode": lambda: decode_sup.decode_columns_device(
            *dargs, block_size=B, out_words=True),
        "le1_decode": lambda: decode_sup.decode_columns_device(
            *le, block_size=le_B),
    }
    scans, sweep = {}, {}
    for name in ("dct", "rand"):
        for way, src, want in (("enc", "bin", "enc"), ("dec", "enc", "bin")):
            x = torch.frombuffer(bytearray((d / f"mmtf_{name}.{src}")
                                           .read_bytes()), dtype=torch.uint8)
            x = x.to(dev)[None]
            ref = torch.frombuffer(bytearray((d / f"mmtf_{name}.{want}")
                                             .read_bytes()), dtype=torch.uint8)
            key = f"mmtf_{name}_{way}"
            errs[key] = err(mmtf_device.mmtf_scan(
                x, lanes=16, encode=way == "enc")[0][0].cpu(), ref)
            scans[key] = (lambda x=x, e=way == "enc":
                          mmtf_device.mmtf_scan(x, lanes=16, encode=e))
            if chunks and hasattr(mmtf_device, "_launch"):
                for c in chunks:
                    sweep[key, c] = (lambda x=x, e=way == "enc", c=c:
                                     mmtf_device._launch(x, 16, e, c))
    dispatch = {
        "dispatch_deep": lambda: unpack_device.dispatch_packed(
            *packs["deep"], out_words=True),
        "dispatch_flat": lambda: unpack_device.dispatch_packed(
            *packs["flat"], out_words=True),
    }
    timing = _timing()
    res = dict(root=root,
               device_ms=timing.graph_ms({**kernels, **scans, **dispatch}),
               event_ms=timing.cuda_ms({**kernels, **dispatch}),
               ops_per_call={k: timing.graph_ops(fn)
                             for k, fn in dispatch.items()},
               max_abs_err=errs,
               shapes=dict(encode=list(xd.shape), le_block=le_B,
                           le_cmds=int(le_cols[4][0]), mmtf=[1, MIB]))
    if sweep:
        t = timing.graph_ms(sweep)
        res["mmtf_chunk_ms"] = {f"{k} C={c}": v for (k, c), v in t.items()}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        res["mmtf_fit"] = {k: _fit(chunks, [t[k, c] for c in chunks],
                                   MIB // 16, sms, mmtf_device.CHUNK)
                           for k in scans}
    return res


def _fit(chunks: list[int], ms: list[float], units: int, sms: int,
         chunk: int) -> dict:
    """Least-squares T(C) = a C ceil(K / sms) + b K + c, K = ceil(U / C):
    a and b in ns per step, and the phases at ``chunk`` in ms."""
    import numpy as np

    def row(c):
        k = -(-units // c)
        return [c * -(-k // sms), k, 1.0]
    (a, b, c0), *_ = np.linalg.lstsq(np.array([row(c) for c in chunks]),
                                     np.array(ms), rcond=None)
    r = row(chunk)
    return dict(step_ns=a * 1e6, carry_step_ns=b * 1e6, chunk=chunk,
                chunk_pass_ms=a * r[0], carry_ms=b * r[1], rest_ms=c0)


def _deep_args(pk, arrs, unpack_device):
    """The resolver's planes, for a root from before hrt1_unpack_resolve."""
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
    ap.add_argument("--mmtf-chunks", nargs="*", type=int, default=[])
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        print(json.dumps(time_root(args.root, pathlib.Path(args.data),
                                   args.mmtf_chunks)), flush=True)
        return 0
    lines = []
    with tempfile.TemporaryDirectory() as td:
        make_inputs(pathlib.Path(td))
        for r in args.roots:
            res = subprocess.run(
                [sys.executable, __file__, "--root",
                 str(pathlib.Path(r).resolve()), "--data", td,
                 "--mmtf-chunks", *map(str, args.mmtf_chunks)],
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
