"""User-facing compress / decompress of the HRT1 container, on torch.

Port of hypersonic_rle_kit_tpu/api.py.  ``decompress(buf, device=...)`` is
the device half of the round trip: the host slices the container into
payload sections (container.pack_for_device, shared), ships them in two
copies, and the device bit-unpacks, resolves (hrt1_resolve_deep, deep
layout) and decodes (hrt1_decode).  There is no fallback: a kernel error or
``torch.cuda.OutOfMemoryError`` propagates, and ``kernel_launch_counts()``
shows which kernels ran.
"""

from __future__ import annotations

import numpy as np
import torch

from hypersonic_rle_kit_tpu import spec as spec_mod
from hypersonic_rle_kit_tpu.parallel import container

from .ops import _kernels, decode_sup, device as device_ops, planar
from .ops import unpack_device

# per-family minimum run length for the HRT1 cost model: one command must
# not cost more than it saves (8-bit commands cost ~3 bytes)
_DEFAULT_MIN_COUNT = 6

kernel_launch_counts = _kernels.launch_counts
reset_kernel_launch_counts = _kernels.reset_launch_counts


def hrt1_params(cspec: "spec_mod.CodecSpec"):
    """Map a reference codec spec onto the HRT1 pipeline's parameters:
    ``(width_bytes, default_block_size, min_count, single)``.

    Widths (16..128-bit families) decode in w byte lanes; Short / Greedy /
    LUT lower the emission threshold to 4, Packed to 5; Single restricts
    emission to the block's dominant byte (see the JAX package's
    ``api.hrt1_params`` for the full mapping)."""
    F = spec_mod.Family
    w = max(1, cspec.width // 8) if cspec.family in (
        F.RLE8, F.RLEX, F.LUT, F.SHORT) else 1
    if cspec.family is F.MEMCPY:
        w = 1
    block = 196608 if w in (3, 6) else container.DEFAULT_BLOCK_SIZE
    if cspec.short or cspec.greedy or cspec.family is F.LUT:
        min_count = 4
    elif cspec.packed:
        min_count = 5
    else:
        min_count = _DEFAULT_MIN_COUNT
    return w, block, min_count, bool(cspec.single)


def _deinterleave_block(row: np.ndarray, n: int, w: int) -> tuple[np.ndarray, int]:
    """One padded block row -> byte-lane layout prefix of length
    ceil(n/w)*w (rest zero), with the transformed valid length."""
    B = row.shape[0]
    bt = -(-n // w) * w
    out = np.zeros(B, np.uint8)
    out[:bt] = row[:bt].reshape(bt // w, w).T.reshape(-1)
    return out, bt


def _interleave_block(row: np.ndarray, n: int, w: int) -> np.ndarray:
    """Inverse of :func:`_deinterleave_block`, trimmed to ``n`` bytes."""
    bt = -(-n // w) * w
    return row[:bt].reshape(w, bt // w).T.reshape(-1)[:n]


def _deinterleave(x: np.ndarray, lens: np.ndarray, w: int):
    """[nb, B] blocks + original lengths -> transformed blocks + lengths."""
    if w == 1:
        return x, lens
    nb, B = x.shape
    xt = x.reshape(nb, B // w, w).swapaxes(1, 2).reshape(nb, B)
    tlens = (-(-lens.astype(np.int64) // w) * w).astype(np.int32)
    for b in np.flatnonzero(lens != B):           # partial (tail) blocks
        xt[b], tlens[b] = _deinterleave_block(x[b], int(lens[b]), w)
    return xt, tlens


def _interleave(y: np.ndarray, orig_len: np.ndarray, w: int) -> np.ndarray:
    """Inverse of :func:`_deinterleave` on decoded [nb, B] byte lanes."""
    nb, B = y.shape
    yi = np.ascontiguousarray(
        y.reshape(nb, w, B // w).swapaxes(1, 2).reshape(nb, B))
    for b in np.flatnonzero(orig_len != B):       # partial (tail) blocks
        n = int(orig_len[b])
        yi[b, :n] = _interleave_block(y[b], n, w)
    return yi


def _as_bytes_array(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def _to_blocks(arr: np.ndarray, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    n = arr.size
    nb = max(1, -(-n // block_size))
    padded = np.zeros(nb * block_size, np.uint8)
    padded[:n] = arr
    lens = np.full(nb, block_size, np.int32)
    lens[-1] = n - (nb - 1) * block_size
    return padded.reshape(nb, block_size), lens


def compress_bounds(in_size: int, block_size: int = container.DEFAULT_BLOCK_SIZE) -> int:
    """Worst-case HRT1 size: header + table + per-block worst payload."""
    nb = max(1, -(-in_size // block_size))
    per_block = block_size + block_size // _DEFAULT_MIN_COUNT * 8 + 64
    return 24 + nb * (16 + per_block)


def _host_encode(x, lens, cap, block_size, min_count, only_sym=None):
    outs = [planar.host_encode_block(
        x[b, :lens[b]], cap, block_size, min_count,
        None if only_sym is None else int(only_sym[b]))
        for b in range(x.shape[0])]
    return ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])


def compress(data, codec: str | int | spec_mod.CodecSpec = "8 Bit", *,
             block_size: int | None = None, backend: str = "auto",
             device="cpu") -> bytes:
    """Compress to the HRT1 container; the bytes equal the JAX package's.

    ``backend``: 'native' (C++ host encoder), 'host' (numpy golden),
    'device' (torch ``ops/device.encode_blocks`` on ``device``) or 'auto'
    (native if the library builds, else 'device').  'kernel' (the Pallas
    encoder's port) is not ported yet and raises NotImplementedError."""
    if backend == "kernel":
        raise NotImplementedError(
            "compress(backend='kernel') needs the encode kernel port "
            "(ROADMAP.md, queue A item 7); use 'native', 'device' or 'host'")
    if backend not in ("auto", "native", "device", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    cspec = _resolve(codec)
    w, bdef, min_count, single = hrt1_params(cspec)
    if block_size is None:
        block_size = bdef
    if block_size % w:
        raise ValueError(f"block_size {block_size} not divisible by the "
                         f"{w}-byte symbol width of {cspec.name!r}")
    arr = _as_bytes_array(data)
    if arr.size == 0:
        return container.serialize_blocks(
            cspec.index, 0, block_size, min_count,
            np.zeros((0, 1), np.uint8), np.zeros((0, 1), np.int32),
            np.zeros((0, 1), np.int32), np.zeros((0, block_size), np.uint8),
            np.zeros(0, np.int32), np.zeros(0, np.int32))
    x, lens = _deinterleave(*_to_blocks(arr, block_size), w)
    only_sym = None
    if single:
        # dominant byte per block in one O(n) pass: one flat bincount over
        # (block, byte) pairs, padding masked by weight
        nb_, B_ = x.shape
        flat = (np.arange(nb_, dtype=np.int64)[:, None] * 256
                + x.astype(np.int64))
        wt = (np.arange(B_)[None, :] < lens[:, None]).astype(np.float64)
        hist = np.bincount(flat.ravel(), weights=wt.ravel(),
                           minlength=nb_ * 256).reshape(nb_, 256)
        only_sym = hist.argmax(axis=1).astype(np.int32)
    cap = planar.capacity_for(block_size, min_count)
    cols = None
    if backend in ("auto", "native"):
        from hypersonic_rle_kit_tpu.utils import native
        cols = native.planar_from_bytes(x, lens, cap, min_count,
                                        only_sym=only_sym)
        if cols is None and backend == "native":
            raise RuntimeError("native runtime unavailable")
    if cols is None and backend in ("auto", "device"):
        dev = torch.device(device)
        pb = device_ops.encode_blocks(
            torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev),
            capacity=cap, min_count=min_count,
            only_sym=None if only_sym is None
            else torch.from_numpy(only_sym).to(dev))
        cols = [t.cpu().numpy() for t in
                (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)]
    if cols is None:
        cols = _host_encode(x, lens, cap, block_size, min_count, only_sym)
    return container.serialize_blocks(
        cspec.index, arr.size, block_size, min_count, *cols)


def _to_host_bytes(y: torch.Tensor, words: bool) -> np.ndarray:
    """Device output -> host bytes; from CUDA through one pinned buffer."""
    if y.device.type == "cuda":
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        torch.cuda.current_stream(y.device).synchronize()
        y = host
    yh = y.cpu().numpy()
    return decode_sup.words_to_bytes(yh) if words else yh


def decompress(buf, *, device) -> bytes:
    """Decompress an HRT1 container on ``device`` ('cuda', 'cuda:N' or
    'cpu'; CUDA runs the Hopper kernels, CPU their plain versions).

    Raises ContainerError on a malformed or hostile container."""
    buf = bytes(buf)
    info, blocks = container.parse(buf)
    if info.uncompressed_size == 0:
        return b""
    try:
        w = hrt1_params(spec_mod.by_index(info.codec_index))[0]
    except (IndexError, KeyError):
        w = 1
    B = info.block_size
    if B % w:
        raise container.ContainerError(
            f"block size {B} not divisible by codec "
            f"{info.codec_index}'s {w}-byte width")
    dev = torch.device(device)

    orig_len = np.full(info.n_blocks, B, np.int32)
    orig_len[-1] = info.uncompressed_size - (info.n_blocks - 1) * B
    tlen = orig_len
    if w > 1:   # widths decode in the byte-lane domain (hrt1_params)
        tlen = (-(-orig_len.astype(np.int64) // w) * w).astype(np.int32)
    # width-1 and whole-word widths take the words form (free byte view)
    words = (w == 1 or w % 4 == 0) and B % 4 == 0

    y = None
    pk = container.pack_for_device(buf, parsed=(info, blocks))
    if pk is not None:
        pk["block_len"] = tlen
        arrs = unpack_device.ship_packed(pk, dev)
        yd, bad = unpack_device.dispatch_packed(pk, arrs, with_flags=True,
                                                out_words=words)
        # a set flag marks a hostile deep container: its stored sub-header
        # counts disagree with the escape population; the validating host
        # reader below raises ContainerError for it
        if bad is None or not bool(bad.any()):
            y = _to_host_bytes(yd, words)
    if y is None:
        # non-uniform bit widths (pack_for_device -> None) or a flagged
        # container: unpack on the host, decode the columns on the device
        _, (sym, count, lit_len, lits, n_cmds, n_lits, _bl) = \
            container.deserialize_to_planar(buf)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (sym, count, lit_len, lits, n_cmds, n_lits, tlen)]
        y = _to_host_bytes(decode_sup.decode_columns_device(
            *t, block_size=B, out_words=words), words)
    if w > 1:
        y = _interleave(y, orig_len, w)
    # only the last block can be partial (container.parse), so masking
    # each block to its length is one slice of the row-major rows
    return y.reshape(-1)[:info.uncompressed_size].tobytes()


def _resolve(codec) -> spec_mod.CodecSpec:
    if isinstance(codec, spec_mod.CodecSpec):
        return codec
    if isinstance(codec, int):
        return spec_mod.by_index(codec)
    return spec_mod.by_name(codec)
