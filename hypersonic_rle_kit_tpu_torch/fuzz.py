"""Device fuzz lane: HRT1 containers, real and mutated, through the port's
decoders.

Port of the ``--device`` lane of hypersonic_rle_kit_tpu/fuzz.py, with its
own copies of that module's input generators and codec subset (the same
seeds give the same inputs).  Each input is compressed with each codec and decompressed on the
device; then the container is mutated (random bit flips) and truncated.
A mutated container must raise ``ContainerError`` or decode without
another exception, and a truncated one must raise ``ContainerError``: on
CUDA this holds the kernels (hrt1_unpack_resolve, hrt1_decode) to hostile
input, the analog of the reference's buffer-scramble trap
(rle_fuzz.c:629-636).

Usage:  python -m hypersonic_rle_kit_tpu_torch.fuzz --device cuda|cpu
        [--iterative|--random] [--iterations N] [--sections N]
        [--codec NAME ...]
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np
import torch

from . import api, spec as spec_mod
from .parallel import container

BOUNDARY_LENGTHS = (
    [1, 2, 3, 5, 7, 13, 30, 31, 32, 33, 125, 126, 127, 128, 129, 254, 255,
     256, 257, 280, 767, 768, 8191, 8192]
    + [65527, 65528, 65535, 65536, 65544, 65560]
)


def _section(rng: np.random.Generator, length: int, kind: str,
             sym_len: int) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, 256, length, dtype=np.uint8)
    sym = rng.integers(0, 256, sym_len, dtype=np.uint8)
    reps = length // sym_len + 2
    return np.tile(sym, reps)[:length]


def iterative_inputs(sections: int, seed: int = 1):
    """Deterministic odometer over (length-set, kinds, symbol length)."""
    rng = np.random.default_rng(seed)
    length_sets = [BOUNDARY_LENGTHS[i::7] for i in range(7)]
    for sym_len in (1, 2, 3, 4, 7, 8, 12, 16):
        for lengths in length_sets:
            for kinds in itertools.islice(
                    itertools.product(("random", "repeat"), repeat=sections),
                    0, None, max(1, 2 ** sections // 8)):
                parts = [
                    _section(rng, lengths[i % len(lengths)], kinds[i], sym_len)
                    for i in range(sections)
                ]
                yield np.concatenate(parts).tobytes()


def random_inputs(sections: int, iterations: int, seed: int = 0xF00D):
    rng = np.random.default_rng(seed)
    for _ in range(iterations):
        parts = []
        for _ in range(sections):
            length = int(rng.choice(BOUNDARY_LENGTHS))
            kind = "random" if rng.random() < 0.5 else "repeat"
            parts.append(_section(rng, length, kind,
                                  int(rng.integers(1, 17))))
        yield np.concatenate(parts).tobytes()


# default device-fuzz codec subset: one per HRT1 parameter family
# (width x threshold x single), see api.hrt1_params
DEVICE_FUZZ_CODECS = (
    "8 Bit", "8 Bit Packed", "8 Bit Single", "8 Bit 3LUT Short",
    "16 Bit (Symbol)", "24 Bit (Byte)", "32 Bit Packed (Byte)",
    "48 Bit (Symbol)", "64 Bit 3LUT Short Grdy (Byte)",
    "128 Bit (Symbol)",
)


def _decompress_synced(blob: bytes, dev: torch.device) -> bytes:
    """``api.decompress`` that waits for the card before it returns or
    raises, so an asynchronous kernel fault surfaces at this input, not at
    a later one (a container rejected after a launch included)."""
    try:
        return api.decompress(blob, device=dev)
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def fuzz_device_one(data: bytes, s: spec_mod.CodecSpec,
                    rng: np.random.Generator, device) -> str | None:
    """Round-trip one input through one codec on ``device``, then decode 4
    mutations and 3 truncations of the container; returns an error string
    or None.  On CUDA the round trip must launch hrt1_decode."""
    dev = torch.device(device)
    blob = api.compress(data, s, device=dev)
    launches = api.kernel_launch_counts()["hrt1_decode"]
    dec = _decompress_synced(blob, dev)
    if dec != data:
        return f"device round-trip mismatch ({len(dec)} vs {len(data)})"
    if (dev.type == "cuda"
            and api.kernel_launch_counts()["hrt1_decode"] == launches):
        return "the CUDA lane decoded without launching hrt1_decode"
    for _ in range(4):
        m = bytearray(blob)
        for _ in range(int(rng.integers(1, 9))):
            m[int(rng.integers(len(m)))] ^= 1 << int(rng.integers(8))
        try:
            _decompress_synced(bytes(m), dev)
        except container.ContainerError:
            pass              # typed rejection is the desired outcome
        except Exception as e:  # noqa: BLE001 - the trap itself
            return (f"mutated container escaped validation with "
                    f"{type(e).__name__}: {e}")
    for cut in (1, len(blob) // 2, len(blob) - 1):
        try:
            _decompress_synced(blob[:cut], dev)
            return f"truncated container (len {cut}) accepted"
        except container.ContainerError:
            pass
        except Exception as e:  # noqa: BLE001
            return f"truncated container raised {type(e).__name__}: {e}"
    return None


def run_device(inputs, specs, max_failures: int = 1, log=print,
               seed: int = 0xD0D0, *, device) -> int:
    """Fuzz every input with every codec spec on ``device``; returns the
    number of failures (stops at ``max_failures``), each logged and its
    input saved to ``fuzz-failure.bin``."""
    rng = np.random.default_rng(seed)
    failures = 0
    for n, data in enumerate(inputs):
        for s in specs:
            err = fuzz_device_one(data, s, rng, device)
            if err:
                failures += 1
                with open("fuzz-failure.bin", "wb") as f:
                    f.write(data)
                log(f"DEVICE FAILURE [{s.name}] len={len(data)}: {err} "
                    f"(input saved to fuzz-failure.bin)")
                if failures >= max_failures:
                    return failures
        if (n + 1) % 5 == 0:
            log(f"  {n + 1} inputs x {len(specs)} codecs clean ({device})")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hsrlekit-torch-fuzz")
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"),
                    help="where the containers are decoded: 'cuda' runs the "
                         "Hopper kernels, 'cpu' their plain versions")
    ap.add_argument("--iterative", action="store_true")
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--sections", type=int, default=6)
    ap.add_argument("--codec", action="append", default=None)
    args = ap.parse_args(argv)

    specs = [spec_mod.by_name(n) for n in DEVICE_FUZZ_CODECS]
    if args.codec:
        specs = [s for s in spec_mod.REGISTRY if s.name in args.codec]
    if args.iterative:
        inputs = itertools.islice(iterative_inputs(args.sections),
                                  args.iterations)
    else:
        inputs = random_inputs(args.sections, args.iterations)
    failures = run_device(inputs, specs, device=args.device)
    print(f"fuzz ({args.device}):", "FAILED" if failures else "clean")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
