#!/usr/bin/env python3
"""The word microbenchmarks of scripts/micro_word.py on a CUDA card.

    python3 scripts/micro_word_torch.py

Prints the card's name and power limit first, then, at the script's shape
(nb=256, R=2048, ROW=128, inputs from ``np.random.default_rng(0)``):

- E1 / E2: the i32 words <-> u8 bytes reinterpretations.  On CUDA both are
  ``view``s and move no byte; the time printed is that of the copy that
  would materialise each (``clone``).
- E3: the two hand-written kernels (``word_slice_sum``,
  ``word_sampled_prefix``, ops/micro_word.py) beside the five plain
  formulations of the Pallas bodies; each must equal its kernel exactly.
- E4: the bucket count in both one-hot orientations, plain torch.

Every time is a median of CUDA-event samples (chip_smoke.cuda_ms).  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from chip_smoke import card_line, cuda_ms
from hypersonic_rle_kit_tpu_torch.ops import micro_word as mw

NB, R, ROW = 256, 2048, 128


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("micro_word_torch: torch.cuda.is_available() is "
                         "false")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    R4, B = R // 4, R * ROW
    rng = np.random.default_rng(0)

    # --- E1 / E2: words <-> bytes are views on CUDA ---
    wrd = torch.from_numpy(rng.integers(-2**31, 2**31, (NB, R4, ROW),
                                        dtype=np.int64).astype(np.int32)
                           ).to(dev)
    byt = torch.from_numpy(rng.integers(0, 256, (NB, B), dtype=np.int64)
                           .astype(np.uint8)).to(dev)
    out_view = wrd.view(torch.uint8).reshape(NB, B)
    in_view = byt.view(torch.int32).reshape(NB, R4, ROW)
    assert out_view.data_ptr() == wrd.data_ptr()
    assert in_view.data_ptr() == byt.data_ptr()
    t = cuda_ms({"E1": out_view.clone, "E2": in_view.clone})
    print(f"E1 out i32->u8 + reshape: a view (0 bytes moved); materialising "
          f"copy {t['E1']:.4f} ms", flush=True)
    print(f"E2 in u8->i32: a view (0 bytes moved); materialising copy "
          f"{t['E2']:.4f} ms", flush=True)
    del wrd, byt, out_view, in_view

    # --- E3: the kernels beside the five plain formulations ---
    pv = torch.from_numpy(rng.integers(-4, 5, (NB, R, ROW), dtype=np.int64)
                          .astype(np.float32)).to(dev).to(torch.bfloat16)
    kernels = {"word_slice_sum": mw.word_slice_sum,
               "word_sampled_prefix": mw.word_sampled_prefix}
    ref = {k: fn(pv) for k, fn in kernels.items()}
    for name, fn in mw.PLAIN.items():
        k = "word_slice_sum" if "slice" in name else "word_sampled_prefix"
        if not torch.equal(fn(pv), ref[k]):
            raise AssertionError(f"{k} != plain {name!r}")
    fns = {k: (lambda fn=fn: fn(pv)) for k, fn in {**kernels,
                                                  **mw.PLAIN}.items()}
    t = cuda_ms(fns, reps=7, calls=5)
    gb = (pv.numel() * 2 + ref["word_slice_sum"].numel() * 4) / 1e9
    for name, ms in t.items():
        tag = (f" = {gb / ms * 1e3:.1f} GB/s moved" if name in kernels
               else "")
        print(f"E3 {name:28s}: {ms:8.4f} ms{tag}", flush=True)

    # --- E4: bucket counts, both orientations ---
    E, ns = 8192, 16
    s_i = torch.from_numpy(rng.integers(0, ns + 1, (NB, E), dtype=np.int64)
                           .astype(np.int32)).to(dev)
    sb = torch.arange(ns, dtype=torch.int32, device=dev)
    cnts = {"lane-minor E": lambda: (s_i[:, None, :] == sb[None, :, None])
            .to(torch.int32).sum(2),
            "ns-minor": lambda: (s_i[:, :, None] == sb[None, None, :])
            .to(torch.int32).sum(1)}
    if not torch.equal(cnts["lane-minor E"](), cnts["ns-minor"]()):
        raise AssertionError("E4 orientations disagree")
    t = cuda_ms(cnts)
    for name, ms in t.items():
        print(f"E4 cnt {name:14s}: {ms:8.4f} ms", flush=True)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
