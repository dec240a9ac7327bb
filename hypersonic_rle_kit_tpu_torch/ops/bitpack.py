"""Bit-packing of 1..8-bit values, plain torch on the tensor's device.

Port of hypersonic_rle_kit_tpu/ops/bitpack.py (``packed_size``,
``pack_device``, ``unpack_device``; XLA there, no Pallas kernel).  Layout:
value ``k`` of a stream occupies bits ``[k*w, (k+1)*w)``, little-endian
within each byte.  ``pack_np`` / ``unpack_np`` are the port's copies of
the JAX package's numpy goldens.
"""

from __future__ import annotations

import numpy as np
import torch

_U8 = torch.uint8


def packed_size(n_values: int, width: int) -> int:
    """Bytes needed to pack ``n_values`` values of ``width`` bits."""
    return (n_values * width + 7) // 8


def _weights(n: int, device) -> torch.Tensor:
    return (1 << torch.arange(n, dtype=torch.int32, device=device)).to(_U8)


def pack_device(x: torch.Tensor, *, width: int) -> torch.Tensor:
    """Pack ``x[.., n]`` uint8 values (< 2**width) into ``[.., n*width/8]``
    bytes.  ``n * width`` must be a multiple of 8 (pad with zeros
    upstream)."""
    n = x.shape[-1]
    if not 1 <= width <= 8 or n * width % 8:
        raise ValueError(f"want 1 <= width <= 8 and n * width % 8 == 0, got "
                         f"n={n}, width={width}")
    lead = x.shape[:-1]
    shifts = torch.arange(width, dtype=_U8, device=x.device)
    bits = (x.to(_U8)[..., None] >> shifts) & 1        # [.., n, width]
    groups = bits.reshape(*lead, n * width // 8, 8)
    return (groups * _weights(8, x.device)).sum(-1).to(_U8)


def unpack_device(packed: torch.Tensor, *, width: int,
                  n_values: int) -> torch.Tensor:
    """Unpack ``packed[.., m]`` bytes into ``[.., n_values]`` uint8 values."""
    lead = packed.shape[:-1]
    m = packed.shape[-1]
    if not 1 <= width <= 8 or m * 8 < n_values * width:
        raise ValueError(f"want 1 <= width <= 8 and {m} bytes to hold "
                         f"{n_values} values of {width} bits")
    shifts = torch.arange(8, dtype=_U8, device=packed.device)
    bits = (packed.to(_U8)[..., None] >> shifts) & 1   # [.., m, 8]
    bits = bits.reshape(*lead, m * 8)[..., :n_values * width]
    bits = bits.reshape(*lead, n_values, width)
    return (bits * _weights(width, packed.device)).sum(-1).to(_U8)


# numpy goldens -------------------------------------------------------------

def pack_np(x, width: int):
    x = np.asarray(x, np.uint8)
    n = x.shape[-1]
    bits = ((x[..., None] >> np.arange(width, dtype=np.uint8)) & 1)
    groups = bits.reshape(*x.shape[:-1], n * width // 8, 8)
    return (groups << np.arange(8, dtype=np.uint8)).sum(-1).astype(np.uint8)


def unpack_np(packed, width: int, n_values: int):
    packed = np.asarray(packed, np.uint8)
    m = packed.shape[-1]
    bits = ((packed[..., None] >> np.arange(8, dtype=np.uint8)) & 1)
    bits = bits.reshape(*packed.shape[:-1], m * 8)[..., : n_values * width]
    bits = bits.reshape(*packed.shape[:-1], n_values, width)
    return (bits << np.arange(width, dtype=np.uint8)).sum(-1).astype(np.uint8)
