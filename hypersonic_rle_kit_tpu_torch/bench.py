"""Benchmark harness of the port: one JSON line on stdout with the headline
metric, the device half of the repository's ``bench.py`` on torch.

    python -m hypersonic_rle_kit_tpu_torch.bench [--mib 64] [--block 262144]
        [--iters 8] [--quick] [--device cuda|cpu]

Headline (``rle8_device_decode_compressed_input``, GB/s): HRT1 payload
sections already on the card -> decoded bytes on the card,
``unpack_device.dispatch_packed`` (hrt1_unpack_resolve + hrt1_decode) on
the deep + literal-dictionary container of the quantized-DCT corpus,
decoded bytes over the median CUDA-event time of back-to-back calls.
``vs_baseline`` is against the reference's single-thread x86 decode on
video_frame.raw (27.086 GB/s).  The other keys carry ``bench.py``'s names:

  encode_host_gbps, ratio   native planar encode (C++) + container
  host_unpack_gbps          blob -> planar columns (C++ threaded unpack)
  host_pack_gbps            blob -> padded payload sections
  h2d_gbps, h2d_payload_gbps  ship_packed of those sections, synchronized
  ratio_flat, decode_flat_gbps  the headline on the flat layout
  decode_columns_gbps       planar columns on the card -> bytes (hrt1_decode)
  decode_e2e_gbps           blob on the host -> bytes on the card
  encode_kernel_gbps        bytes on the card -> planar columns (hrt1_encode,
                            16 KiB blocks, the public wrapper)
  ratio_/decode_{random,bwt,sh}_gbps  the secondary corpora, <= 16 MiB
  ratio_w64, decode_w64_gbps  "64 Bit Packed (Byte)": decode + re-interleave
  ref_ingest_gbps           native walk of an "8 Bit" reference stream

and the walls users pay for: ``compress_wall_ms`` (``api.compress`` at its
defaults), ``decompress_wall_ms`` (``api.decompress`` at its defaults),
both split into their stages (``compress_split_ms``,
``decompress_split_ms``), ``decompress_small_ms`` (the first 64 KiB and
1 MiB of the corpus), ``device_ms`` (the device time of one call of each
kernel and of ``dispatch_packed``, from CUDA-graph replays) and
``device`` (the card's name).  Numbers are not rounded.

Device rows are timed by CUDA events, host rows and walls on the host
clock (best of ``--iters``, walls best of 3), each closed by a
synchronize.  Every row that decodes or encodes checks its output first
and raises if it differs: no JSON line, non-zero exit.  ``--device cpu``
(for the tests) runs every row on the kernels' plain versions and times
all of them on the host clock; it is no measurement of a device.
Everything but the JSON line goes to stderr, the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import api, datasets
from .formats import rle8 as rle8_fmt
from .ops import (decode_sup, encode_sup, planar, ref_device, transfer,
                  unpack_device)
from .parallel import container
from .utils import native
from .utils.cuda_timing import cuda_ms, graph_ms

METRIC = "rle8_device_decode_compressed_input"
BASELINE_DECODE_GBPS = 27.086   # 25830.4 MiB/s, the reference's README.md:28
BASELINE_ENCODE_GBPS = 3.481    # 3319.6 MiB/s, README.md:28
MIB = 1 << 20
ENCODE_BLOCK = 1 << 14          # the encode row's blocks, as in bench.py


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_of(fn, dev: torch.device, reps: int):
    """Best-of-``reps`` host seconds of ``fn``, each call closed by a
    synchronize, and the last call's result."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def best_wall(fn, dev: torch.device, reps: int = 3) -> float:
    """Best-of-``reps`` host seconds of ``fn`` closed by a synchronize."""
    return best_of(fn, dev, reps)[0]


def compress_split(raw: bytes, dev: torch.device, reps: int = 3) -> dict:
    """api.compress(backend="kernel") of an "8 Bit" stream in its stages,
    each closed by a synchronize; best of ``reps`` per stage (ms)."""
    B = container.DEFAULT_BLOCK_SIZE
    cap = planar.capacity_for(B, 6)
    best = None
    for _ in range(reps):
        t = [time.perf_counter()]
        x, lens = api._to_blocks(np.frombuffer(raw, np.uint8), B)
        xd, tl = transfer.to_device(x, dev), transfer.to_device(lens, dev)
        sync(dev)
        t.append(time.perf_counter())
        cols = encode_sup.encode_blocks_kernel(xd, tl, capacity=cap,
                                               min_count=6)
        sync(dev)
        t.append(time.perf_counter())
        hc = api._columns_to_host(*cols)
        t.append(time.perf_counter())
        blob = container.serialize_blocks(0, len(raw), B, 6, *hc)
        t.append(time.perf_counter())
        ms = np.diff(t) * 1e3
        best = ms if best is None else np.minimum(best, ms)
    if blob != api.compress(raw, "8 Bit", backend="native", device="cpu"):
        raise RuntimeError("compress stages != native compress")
    return dict(zip(("to_blocks_h2d", "encode", "d2h", "serialize"),
                    best.tolist()))


def decompress_split(blob: bytes, raw: bytes, dev: torch.device,
                     reps: int = 3) -> dict:
    """api.decompress of a width-1 HRT1 container in its stages (parse +
    pack on the host, H2D, device decode, D2H into a pinned buffer, host
    slice to ``bytes``), each closed by a synchronize; best of ``reps`` per
    stage (ms).  Raises unless the output equals ``raw``."""
    best = None
    for _ in range(reps):
        t = [time.perf_counter()]
        info, blocks = container.parse(blob)
        pk = container.pack_for_device(blob, parsed=(info, blocks))
        t.append(time.perf_counter())
        arrs = unpack_device.ship_packed(pk, dev)
        sync(dev)
        t.append(time.perf_counter())
        yd, bad = unpack_device.dispatch_packed(pk, arrs, with_flags=True,
                                                out_words=True)
        sync(dev)
        t.append(time.perf_counter())
        y = api._to_host_bytes(yd, words=True)
        t.append(time.perf_counter())
        got = y.reshape(-1)[:info.uncompressed_size].tobytes()
        t.append(time.perf_counter())
        if (bad is not None and bool(bad.any())) or got != raw:
            raise RuntimeError("decompress stages: round trip != input")
        ms = np.diff(t) * 1e3
        best = ms if best is None else np.minimum(best, ms)
    return dict(zip(("parse_pack", "h2d", "device", "d2h", "to_bytes"),
                    best.tolist()))


def call_s(fn, dev: torch.device, iters: int) -> float:
    """Seconds a call of a device row: on CUDA the median CUDA-event time
    of back-to-back calls; on the CPU best of ``iters`` on the host clock."""
    if dev.type == "cuda":
        return cuda_ms({"row": fn}, reps=max(3, iters))["row"] / 1e3
    return best_wall(fn, dev, iters)


def check(ok: bool, row: str) -> None:
    if not ok:
        raise RuntimeError(f"{row}: round trip != input")


def on_card(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return transfer.to_device(np.ascontiguousarray(x), dev)


def trimmed_columns(pcols, dev: torch.device) -> list:
    """Planar columns (deserialize_to_planar's) -> hrt1_decode's arguments
    on ``dev``: command columns trimmed to the widest block's commands
    (128-rounded), literals as int32 words."""
    sym, count, lit_len, lits, n_cmds, n_lits, block_len = pcols
    cu = max(128, -(-int(n_cmds.max()) // 128) * 128)
    return decode_sup.columns_to_device(
        (sym[:, :cu], count[:, :cu], lit_len[:, :cu],
         decode_sup.lits_to_words(lits), n_cmds, n_lits, block_len), dev)


def run(args) -> dict:
    """Every row of the bench on ``args.device``; the JSON object."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: torch.cuda.is_available() is false "
                             "(--device cpu runs the plain versions)")
        log(f"card: {card_line()} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        kind = torch.cuda.get_device_name(dev)
    else:
        log("device: cpu (plain versions of the kernels; host clock)")
        kind = "cpu"
    if native.lib() is None:
        raise RuntimeError("the native host runtime does not build")
    data = datasets.make_dataset(args.mib)
    block, iters = args.block, args.iters
    r: dict = {}

    nb = data.size // block
    n = nb * block
    x = data[:n].reshape(nb, block)
    lens = np.full(nb, block, np.int32)
    cap = planar.capacity_for(block, 6)

    # --- host encode (C++) + container ---
    t, cols = best_of(lambda: native.planar_from_bytes(x, lens, cap), dev,
                      iters)
    r["encode_host_gbps"] = n / t / 1e9
    blob = container.serialize_blocks(0, n, block, 6, *cols)
    r["ratio"] = len(blob) / n
    log(f"host planar encode (C++): {r['encode_host_gbps']:.2f} GB/s; HRT1 "
        f"ratio {100 * r['ratio']:.2f}%")

    # --- host unpack (C++): blob -> planar columns ---
    t, (_, pcols) = best_of(lambda: container.deserialize_to_planar(blob),
                            dev, iters)
    r["host_unpack_gbps"] = n / t / 1e9

    # --- host section pack: blob -> payload sections ---
    t, pk = best_of(lambda: container.pack_for_device(blob), dev, iters)
    r["host_pack_gbps"] = n / t / 1e9
    payload = sum(pk[k].nbytes for k in unpack_device.SECTION_KEYS
                  if isinstance(pk.get(k), np.ndarray))
    log(f"host unpack (C++) {r['host_unpack_gbps']:.2f} GB/s; section pack "
        f"{r['host_pack_gbps']:.2f} GB/s of decoded size ({payload} B "
        f"shipped)")

    # --- H2D of the payload sections (two copies), synchronized ---
    t, dpk = best_of(lambda: unpack_device.ship_packed(pk, dev), dev, iters)
    r["h2d_gbps"] = n / t / 1e9
    r["h2d_payload_gbps"] = payload / t / 1e9
    log(f"H2D: {r['h2d_payload_gbps']:.2f} GB/s of payload = "
        f"{r['h2d_gbps']:.2f} GB/s of decoded size")

    # --- headline: payload sections (card) -> words (card) ---
    xd = on_card(x.view(np.int32), dev)

    def dec():
        return unpack_device.dispatch_packed(pk, dpk, out_words=True)
    check(torch.equal(dec(), xd), "headline decode (deep + litdict)")
    r["ok"] = True
    t = call_s(dec, dev, iters)
    r["gbps"] = n / t / 1e9
    log(f"decode (payload -> bytes, on {dev.type}): {t * 1e3:.4f} ms = "
        f"{r['gbps']:.2f} GB/s (reference x86: {BASELINE_DECODE_GBPS} GB/s)")

    # --- the same on the flat layout ---
    blob_f = container.serialize_blocks(0, n, block, 6, *cols, deep=False)
    r["ratio_flat"] = len(blob_f) / n
    pkf = container.pack_for_device(blob_f)
    dpkf = unpack_device.ship_packed(pkf, dev)

    def dec_f():
        return unpack_device.dispatch_packed(pkf, dpkf, out_words=True)
    check(torch.equal(dec_f(), xd), "flat decode")
    r["decode_flat_gbps"] = n / call_s(dec_f, dev, iters) / 1e9
    log(f"decode flat layout: {r['decode_flat_gbps']:.2f} GB/s (ratio "
        f"{100 * r['ratio_flat']:.2f}%)")

    # --- planar columns (card) -> bytes (card) ---
    dcols = trimmed_columns(pcols, dev)

    def dec_c():
        return decode_sup.decode_columns_device(*dcols, block_size=block,
                                                out_words=True)
    check(torch.equal(dec_c(), xd), "columns decode")
    r["decode_columns_gbps"] = n / call_s(dec_c, dev, iters) / 1e9
    log(f"decode (planar columns -> bytes): {r['decode_columns_gbps']:.2f} "
        f"GB/s")
    del dcols, pcols

    # --- e2e: blob on the host -> bytes on the card ---
    def e2e():
        p = container.pack_for_device(blob)
        return unpack_device.dispatch_packed(
            p, unpack_device.ship_packed(p, dev), out_words=True)
    check(torch.equal(e2e(), xd), "e2e decode")
    r["decode_e2e_gbps"] = n / best_wall(e2e, dev, iters) / 1e9
    log(f"decode e2e (blob -> bytes on {dev.type}, pack + H2D + device): "
        f"{r['decode_e2e_gbps']:.2f} GB/s")

    # --- encode: bytes (card) -> planar columns, 16 KiB blocks ---
    eb = ENCODE_BLOCK
    nbe = n // eb
    xe = data[:nbe * eb].reshape(nbe, eb)
    lens_e = np.full(nbe, eb, np.int32)
    cap_e = planar.capacity_for(eb, 6)
    cols_e = native.planar_from_bytes(xe, lens_e, cap_e)
    xed, led = on_card(xe, dev), on_card(lens_e, dev)

    def enc():
        return encode_sup.encode_blocks_kernel(xed, led, capacity=cap_e,
                                               min_count=6)
    e = transfer.to_host(*enc())
    check(all(np.array_equal(e[i], cols_e[i]) for i in (0, 1, 2, 4, 5)),
          "encode (device columns vs the host encoder)")
    t = call_s(enc, dev, iters)
    r["encode_kernel_gbps"] = nbe * eb / t / 1e9
    log(f"encode ({eb >> 10} KiB blocks): {t * 1e3:.4f} ms = "
        f"{r['encode_kernel_gbps']:.2f} GB/s (reference x86: "
        f"{BASELINE_ENCODE_GBPS} GB/s)")
    del e, cols_e

    # --- device time of one call of each kernel (CUDA-graph replays) ---
    device_ms = None                # not measured off the card
    if dev.type == "cuda":
        args_d, kw_d = unpack_device.section_args(pk, dpk)
        count, lit_len, sym, _ = unpack_device.unpack_resolve(*args_d, **kw_d)
        dargs = (sym, count, lit_len, dpk["lits"], dpk["n_cmds"],
                 dpk["n_lits"], dpk["block_len"])
        device_ms = graph_ms({
            "hrt1_unpack_resolve": lambda: unpack_device.unpack_resolve(
                *args_d, **kw_d),
            "hrt1_decode": lambda: decode_sup.decode_columns_device(
                *dargs, block_size=block, out_words=True),
            "dispatch_packed_deep": dec,
            "dispatch_packed_flat": dec_f,
            "hrt1_encode": lambda: encode_sup._launch(xed, led, None, cap_e,
                                                      6)})
        log("device ms a call (CUDA-graph replays): " + "; ".join(
            f"{k} {v:.4f}" for k, v in device_ms.items()))
    del dpk, dpkf, xd, xed, led

    # --- secondary corpora: incompressible, BWT-like, recency regime ---
    for tag, maker in (("random", datasets.make_random_dataset),
                       ("bwt", datasets.make_bwt_dataset),
                       ("sh", datasets.make_sh_dataset)):
        dd = maker(min(16, max(1, n >> 20)))
        nb2 = dd.size // block
        x2 = dd[:nb2 * block].reshape(nb2, block)
        c2 = native.planar_from_bytes(x2, np.full(nb2, block, np.int32), cap)
        blob2 = container.serialize_blocks(0, nb2 * block, block, 6, *c2)
        r[f"ratio_{tag}"] = len(blob2) / (nb2 * block)
        d3 = trimmed_columns(container.deserialize_to_planar(blob2)[1], dev)

        def dec2(d3=d3):
            return decode_sup.decode_columns_device(*d3, block_size=block,
                                                    out_words=True)
        check(torch.equal(dec2(), on_card(x2.view(np.int32), dev)),
              f"{tag} decode")
        r[f"decode_{tag}_gbps"] = nb2 * block / call_s(dec2, dev, iters) / 1e9
        log(f"[{tag}] ratio {100 * r[f'ratio_{tag}']:.2f}%  decode "
            f"{r[f'decode_{tag}_gbps']:.2f} GB/s")
        del d3

    # --- wide codec: 64-bit packed, decode + re-interleave on the card ---
    wname = "64 Bit Packed (Byte)"
    wblob = api.compress(data[:n], wname, device=dev)
    r["ratio_w64"] = len(wblob) / n
    pkw = container.pack_for_device(wblob)
    if pkw is None:
        raise RuntimeError(f"{wname}: the container does not pack for the "
                           f"device")
    dw = unpack_device.ship_packed(pkw, dev)

    def dec_w():
        yd = unpack_device.dispatch_packed(pkw, dw, out_words=True)
        return decode_sup.interleave_words(yd, w=8)
    (yw,) = transfer.to_host(dec_w())
    check(decode_sup.words_to_bytes(yw).reshape(-1)[:n].tobytes()
          == data[:n].tobytes(), f"{wname} decode")
    r["decode_w64_gbps"] = n / call_s(dec_w, dev, iters) / 1e9
    log(f"[{wname}] ratio {100 * r['ratio_w64']:.2f}%  decode + "
        f"re-interleave {r['decode_w64_gbps']:.2f} GB/s")
    del dw, yw

    # --- reference-stream ingest: native grammar walk of "8 Bit" ---
    rn = min(n, 32 * MIB)
    rblob = rle8_fmt.rle8_compress(data[:rn].tobytes())
    t, res = best_of(lambda: native.ref_parse_planar(
        rblob, 0, 8, 0, 0, rn, 1 << 16), dev, iters)
    if res is None:
        raise RuntimeError("native.ref_parse_planar failed")
    r["ref_ingest_gbps"] = rn / t / 1e9
    check(ref_device.decompress_ref_device(rblob, "8 Bit", device=dev)
          == data[:rn].tobytes(), "reference stream decode")
    log(f"[ref-stream] native walk {r['ref_ingest_gbps']:.2f} GB/s of "
        f"decoded size; device decode round trip equal")

    # --- the walls users pay for: the entry points at their defaults ---
    at = {} if dev.type == "cuda" else {"device": "cpu"}
    raw = data.tobytes()
    r["compress_wall_ms"] = best_wall(
        lambda: api.compress(raw, "8 Bit", **at), dev) * 1e3
    r["compress_split_ms"] = compress_split(raw, dev)
    cblob = api.compress(raw, "8 Bit", **at)
    check(api.decompress(cblob, **at) == raw, "api.decompress")
    r["decompress_wall_ms"] = best_wall(
        lambda: api.decompress(cblob, **at), dev) * 1e3
    r["decompress_split_ms"] = decompress_split(cblob, raw, dev)
    r["decompress_small_ms"] = {}
    for name, size in (("64KiB", 64 << 10), ("1MiB", MIB)):
        small = raw[:size]
        sblob = api.compress(small, "8 Bit", **at)
        check(api.decompress(sblob, **at) == small, f"{name} decompress")
        r["decompress_small_ms"][name] = best_wall(
            lambda: api.decompress(sblob, **at), dev) * 1e3
    log(f"compress wall {r['compress_wall_ms']:.2f} ms, stages "
        + " | ".join(f"{k} {v:.2f}" for k, v in r["compress_split_ms"].items())
        + f" ms; decompress wall {r['decompress_wall_ms']:.2f} ms, stages "
        + " | ".join(f"{k} {v:.2f}"
                     for k, v in r["decompress_split_ms"].items())
        + " ms; small " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in r["decompress_small_ms"].items()))

    return {"metric": METRIC, "value": r["gbps"], "unit": "GB/s",
            "vs_baseline": r["gbps"] / BASELINE_DECODE_GBPS,
            "device": kind, **r, "device_ms": device_ms}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--block", type=int, default=1 << 18)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--quick", action="store_true",
                    help="8 MiB, 3 iterations")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain versions, for the tests")
    args = ap.parse_args(argv)
    if args.quick:
        args.mib, args.iters = 8, 3
    return args


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
