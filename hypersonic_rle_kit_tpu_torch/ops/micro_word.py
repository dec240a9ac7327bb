"""The word microbenchmark's two functions: kernels and plain versions.

Port of the Pallas kernel of scripts/micro_word.py (``mk(body)``, the five
E3 bodies), which reads a painted bf16 plane ``x[nb, R, 128]`` and writes
int32 ``[nb, R/4, 128]``.  The five bodies compute two functions:

- slice-sum (``body_slice_only``, ``body_slice_i32``):
  ``out[b, r, c] = sum_{j<4} x[b, 4r + j, c]``;
- sampled prefix (``body_smalls``, ``body_fused4``, ``body_big1``): with
  ``j = c >> 5``, ``k = c & 31`` and ``y = x[b, 4r + j]``,
  ``out[b, r, c] = 4 y[4k] + 3 y[4k+1] + 2 y[4k+2] + y[4k+3]``.

``word_slice_sum`` and ``word_sampled_prefix`` launch the hand-written
kernels of ``csrc/micro_word.cu`` on CUDA tensors and run their plain
versions on CPU tensors.  The five plain versions below are built as the
bodies build them.  The one-hot products run as ``torch.matmul`` in bf16
(torch has no bf16 -> f32 product on the CPU); for the script's inputs
(integers in -4..4) every product entry is an integer of magnitude <= 16,
exact in bf16, and the entries are summed in float32.
"""

from __future__ import annotations

import torch

from . import _kernels

ROW = 128
_BF16 = torch.bfloat16
_I32 = torch.int32


def _check(x, *, sampled: bool) -> None:
    """The wrappers' contract, the same on every device: a contiguous bf16
    ``[nb, R, row]`` plane, ``R % 4 == 0``, ``row % 4 == 0`` (``row ==
    128`` for the sampled prefix) and a 16-byte-aligned data pointer, as
    every plane the microbenchmark allocates is.  The plain versions take
    any shape."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError(f"want a [nb, R, row] tensor, got {type(x)}")
    if x.dtype != _BF16:
        raise TypeError(f"x: dtype {x.dtype}, want {_BF16}")
    nb, R, row = x.shape
    if R % 4 or row < 4 or row % 4:
        raise ValueError(f"want R % 4 == 0 and row % 4 == 0, got "
                         f"{tuple(x.shape)}")
    if sampled and row != ROW:
        raise ValueError(f"the sampled prefix wants rows of {ROW}, got {row}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")


def _slices(x: torch.Tensor) -> list[torch.Tensor]:
    """``pj`` of the bodies: the four strided row slices [nb, R/4, row]."""
    nb, R, row = x.shape
    v = x.reshape(nb, R // 4, 4, row)
    return [v[:, :, j, :] for j in range(4)]


# ---------------------------------------------------------------------------
# plain versions, one per Pallas body
# ---------------------------------------------------------------------------

def slice_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """``body_slice_only``: the four slices summed in float32."""
    p = _slices(x)
    return (p[0].float() + p[1].float() + p[2].float() + p[3].float()
            ).to(_I32)


def slice_sum_i32(x: torch.Tensor) -> torch.Tensor:
    """``body_slice_i32``: cast to int32 first, then summed."""
    p = _slices(x.to(_I32))
    return p[0] + p[1] + p[2] + p[3]


def _one_hot(t: int, j: int, device) -> torch.Tensor:
    """[ROW, ROW] bf16: 1 where lo(c) <= row <= lo(c) + t and c >> 5 == j."""
    lane = torch.arange(ROW, device=device)[None, :]
    li = torch.arange(ROW, device=device)[:, None]
    lo = (lane & 31) * 4
    return ((li >= lo) & (li <= lo + t) & ((lane >> 5) == j)).to(_BF16)


def _mm(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, m).float()


def _sum4(acc: torch.Tensor) -> torch.Tensor:
    return (acc[..., :ROW] + acc[..., ROW:2 * ROW] + acc[..., 2 * ROW:3 * ROW]
            + acc[..., 3 * ROW:]).to(_I32)


def sampled_prefix_smalls(x: torch.Tensor) -> torch.Tensor:
    """``body_smalls``: 16 products of [R/4, 128] x [128, 128]."""
    p = _slices(x)
    acc = None
    for t in range(4):
        for j in range(4):
            mm = _mm(p[j], _one_hot(t, j, x.device))
            acc = mm if acc is None else acc + mm
    return acc.to(_I32)


def _fused_block(j: int, device) -> torch.Tensor:
    """[128, 512]: the four t one-hots of slice j side by side."""
    return torch.cat([_one_hot(t, j, device) for t in range(4)], dim=1)


def sampled_prefix_fused4(x: torch.Tensor) -> torch.Tensor:
    """``body_fused4``: 4 products of [R/4, 128] x [128, 512]."""
    p = _slices(x)
    acc = None
    for j in range(4):
        mm = _mm(p[j], _fused_block(j, x.device))
        acc = mm if acc is None else acc + mm
    return _sum4(acc)


def sampled_prefix_big1(x: torch.Tensor) -> torch.Tensor:
    """``body_big1``: 1 product of [R/4, 512] x [512, 512]."""
    X = torch.cat(_slices(x), dim=-1)
    M = torch.cat([_fused_block(j, x.device) for j in range(4)], dim=0)
    return _sum4(_mm(X, M))


# the five bodies' plain versions, by the script's E3 labels
PLAIN = {
    "slice-only(bf16->f32 sum)": slice_sum_f32,
    "slice-i32": slice_sum_i32,
    "16 small matmuls": sampled_prefix_smalls,
    "4 fused [128,512]": sampled_prefix_fused4,
    "1 big [512,512]": sampled_prefix_big1,
}


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, x: torch.Tensor, *args) -> torch.Tensor:
    dev = x.device
    nb, R, row = x.shape
    out = torch.empty((nb, R // 4, row), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_kernels.lib("micro_word"), name)(
            _kernels.ptr(x), _kernels.ptr(out), nb * R // 4, *args, stream)
    _kernels.check(rc, name)
    _kernels.count_launch(name)
    return out


def _device_type(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    return x.device.type


def word_slice_sum(x: torch.Tensor) -> torch.Tensor:
    """bf16 ``[nb, R, row]`` -> int32 ``[nb, R/4, row]``, the sum of each
    group of four rows.  CUDA tensors launch the word_slice_sum kernel, CPU
    tensors take :func:`slice_sum_f32`."""
    _check(x, sampled=False)
    if _device_type(x, "word_slice_sum") == "cpu":
        return slice_sum_f32(x)
    return _launch("word_slice_sum", x, x.shape[2])


def word_sampled_prefix(x: torch.Tensor) -> torch.Tensor:
    """bf16 ``[nb, R, 128]`` -> int32 ``[nb, R/4, 128]``, the sampled 4-tap
    prefix.  CUDA tensors launch the word_sampled_prefix kernel, CPU tensors
    take :func:`sampled_prefix_big1`."""
    _check(x, sampled=True)
    if _device_type(x, "word_sampled_prefix") == "cpu":
        return sampled_prefix_big1(x)
    return _launch("word_sampled_prefix", x)
