"""User-facing compress / decompress of the HRT1 container, on torch.

Port of hypersonic_rle_kit_tpu/api.py; both directions run on the device:

- ``compress(data, codec, backend="kernel", device="cuda")``: the blocks go
  to the card in one pinned copy, the width de-interleave runs there, the
  hrt1_encode kernel (ops/encode_sup.py) emits the planar columns, and they
  come back through pinned buffers to ``container.serialize_blocks``.
- ``decompress(buf, device=...)``: the host slices the container into
  payload sections (container.pack_for_device), ships them in two
  copies, and the device bit-unpacks and resolves (hrt1_unpack_resolve),
  decodes (hrt1_decode) and re-interleaves the widths.  The JAX package's
  ``backend="device"`` (plain torch decode) and ``"host"`` (numpy) are
  there too.

There is no fallback: a kernel error or ``torch.cuda.OutOfMemoryError``
propagates, and ``kernel_launch_counts()`` shows which kernels ran.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec as spec_mod
from .ops import _kernels, decode_sup, device as device_ops, encode_sup
from .ops import planar, unpack_device
from .ops.transfer import to_device, to_host
from .parallel import container
from .utils import native

# per-family minimum run length for the HRT1 cost model: one command must
# not cost more than it saves (8-bit commands cost ~3 bytes)
_DEFAULT_MIN_COUNT = 6

kernel_launch_counts = _kernels.launch_counts
reset_kernel_launch_counts = _kernels.reset_launch_counts


def kernel_fallback_count() -> int:
    """Always 0: the port has no fallback from a kernel to another decoder
    (the JAX package counts its kernel -> XLA capacity fallbacks here); a
    kernel error propagates."""
    return 0


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


def _lane_lens(lens: np.ndarray, w: int) -> np.ndarray:
    """Block lengths -> their transformed lengths ceil(n/w)*w."""
    return (-(-lens.astype(np.int64) // w) * w).astype(np.int32)


def _deinterleave(x: torch.Tensor, lens: np.ndarray, w: int) -> torch.Tensor:
    """[nb, B] blocks (original lengths ``lens``) -> byte-lane layout, on
    ``x``'s device.  A partial (tail) block transforms its ceil(n/w)*w
    prefix and is zero after it; the valid lengths are :func:`_lane_lens`."""
    if w == 1:
        return x
    nb, B = x.shape
    xt = x.reshape(nb, B // w, w).transpose(1, 2).reshape(nb, B)
    for b in np.flatnonzero(lens != B):
        bt = -(-int(lens[b]) // w) * w
        xt[b, :bt] = x[b, :bt].reshape(bt // w, w).t().reshape(-1)
        xt[b, bt:] = 0
    return xt


def _interleave_plane(a: torch.Tensor, *, nb: int, w: int,
                      B: int) -> torch.Tensor:
    """Byte-plane re-interleave on the device for the widths whose lanes
    are not whole words (16/24/48-bit): [nb, B] lanes -> original order."""
    return a.reshape(nb, w, B // w).transpose(1, 2).reshape(nb, B)


def _interleave(y: torch.Tensor, orig_len: np.ndarray, w: int) -> torch.Tensor:
    """Inverse of :func:`_deinterleave` on decoded lanes, on ``y``'s device.

    ``y`` is [nb, B/4] int32 words (w % 4 == 0) or [nb, B] bytes, and the
    result has the same form.  A partial (tail) block re-interleaves its
    ceil(n/w)*w prefix, as the JAX package's host fix-up does."""
    words = y.dtype == torch.int32
    nb = y.shape[0]
    lane = y.view(torch.uint8) if words else y
    B = lane.shape[1]
    yi = (decode_sup.interleave_words(y, w=w) if words
          else _interleave_plane(y, nb=nb, w=w, B=B))
    out = yi.view(torch.uint8) if words else yi
    for b in np.flatnonzero(orig_len != B):
        n = int(orig_len[b])
        bt = -(-n // w) * w
        out[b, :n] = lane[b, :bt].reshape(w, bt // w).t().reshape(-1)[:n]
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


def _dominant_bytes(x: np.ndarray, tlens: np.ndarray) -> np.ndarray:
    """Single's dominant byte of each block's first ``tlens[b]`` bytes, the
    first maximum on ties (np.argmax).  The width transform permutes the
    bytes inside that prefix, so the blocks in either order give it."""
    return np.array([np.bincount(x[b, :tlens[b]], minlength=256).argmax()
                     for b in range(x.shape[0])], np.int32)


def _columns_to_host(sym, count, lit_len, lits, n_cmds, n_lits) -> list:
    """Device columns -> numpy columns for ``container.serialize_blocks``,
    which reads only ``[:n_cmds]`` / ``[:n_lits]`` of a row: the rows cross
    trimmed to the widest block's counts."""
    return _shares_to_host([(sym, count, lit_len, lits, n_cmds, n_lits)])


def _shares_to_host(shares) -> list:
    """:func:`_columns_to_host` of several shares of the block axis (each
    ``(sym, count, lit_len, lits, n_cmds, n_lits)``, on any devices), their
    rows concatenated in order and trimmed to the widest block of all;
    every copy queued before one synchronisation of each card."""
    counts = to_host(*(t for cols in shares for t in cols[4:]))
    nc, nl = np.concatenate(counts[0::2]), np.concatenate(counts[1::2])
    c, m = max(int(nc.max(initial=0)), 1), max(int(nl.max(initial=0)), 1)
    rows = to_host(*(t for sym, count, lit_len, lits, _, _ in shares
                     for t in (sym[:, :c], count[:, :c], lit_len[:, :c],
                               lits[:, :m])))
    return [np.concatenate(rows[i::4]) for i in range(4)] + [nc, nl]


def _encode_on_device(x: np.ndarray, lens: np.ndarray, w: int, cap: int,
                      min_count: int, only_sym, dev: torch.device,
                      kernel: bool) -> list:
    """[nb, B] host blocks (original lengths ``lens``) -> numpy columns of
    the transformed blocks, encoded on ``dev`` by the hrt1_encode wrapper
    (``kernel``) or the plain torch encoder."""
    xd = _deinterleave(to_device(x, dev), lens, w)
    tl = to_device(_lane_lens(lens, w), dev)
    os_ = None if only_sym is None else to_device(only_sym, dev)
    if kernel:
        cols = encode_sup.encode_blocks_kernel(
            xd, tl, capacity=cap, min_count=min_count, only_sym=os_)
    else:
        pb = device_ops.encode_blocks(xd, tl, capacity=cap,
                                      min_count=min_count, only_sym=os_)
        cols = (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)
    return _columns_to_host(*cols)


def compress(data, codec: str | int | spec_mod.CodecSpec = "8 Bit", *,
             block_size: int | None = None, backend: str = "auto",
             device="cuda") -> bytes:
    """Compress to the HRT1 container; the bytes equal the JAX package's.

    ``device`` is the card unless the caller asks for ``"cpu"``.
    ``backend``: 'kernel' (the hrt1_encode wrapper on ``device``: the
    kernel on CUDA, its plain version on the CPU), 'device' (the plain torch
    ``ops/device.encode_blocks`` on ``device``), 'native' (C++ host
    encoder), 'host' (numpy golden) or 'auto' ('kernel' when ``device`` is
    CUDA; on the CPU native if the library builds, else 'device')."""
    if backend not in ("auto", "kernel", "device", "native", "host"):
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
    dev = torch.device(device)
    if backend == "auto":
        backend = ("kernel" if dev.type == "cuda"
                   else "native" if native.lib() is not None else "device")
    x, lens = _to_blocks(arr, block_size)
    tlens = _lane_lens(lens, w)
    only_sym = _dominant_bytes(x, tlens) if single else None
    cap = planar.capacity_for(block_size, min_count)
    if backend in ("kernel", "device"):
        cols = _encode_on_device(x, lens, w, cap, min_count, only_sym, dev,
                                 kernel=backend == "kernel")
    else:
        xt = _deinterleave(torch.from_numpy(x), lens, w).numpy()
        if backend == "native":
            cols = native.planar_from_bytes(xt, tlens, cap, min_count,
                                            only_sym=only_sym)
            if cols is None:
                raise RuntimeError("native runtime unavailable")
        else:
            cols = _host_encode(xt, tlens, cap, block_size, min_count,
                                only_sym)
    return container.serialize_blocks(
        cspec.index, arr.size, block_size, min_count, *cols)


def _to_host_bytes(y: torch.Tensor, words: bool) -> np.ndarray:
    """Device output -> host bytes; from CUDA through one pinned buffer."""
    (yh,) = to_host(y)
    return decode_sup.words_to_bytes(yh) if words else yh


def decompress(buf, *, backend: str = "auto", device="cuda") -> bytes:
    """Decompress an HRT1 container.

    ``backend``: 'auto' or 'kernel' (on ``device``: 'cuda', the default,
    or 'cuda:N' runs the Hopper kernels, 'cpu' their plain versions),
    'device' (the container unpacked on the host, then the plain torch
    ``ops/device.decode_blocks`` on ``device``) or 'host' (numpy,
    ``planar.host_decode_block``).  Every backend gives the same bytes.

    Raises ContainerError on a malformed or hostile container."""
    if backend not in ("auto", "kernel", "device", "host"):
        raise ValueError(f"unknown backend {backend!r}")
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
    dev = torch.device("cpu" if backend == "host" else device)

    orig_len = np.full(info.n_blocks, B, np.int32)
    orig_len[-1] = info.uncompressed_size - (info.n_blocks - 1) * B
    tlen = _lane_lens(orig_len, w)   # widths decode in byte lanes
    # width-1 and whole-word widths decode to the words form (free byte
    # view) on the kernel path; the plain decoders give bytes
    words = (backend in ("auto", "kernel") and (w == 1 or w % 4 == 0)
             and B % 4 == 0)
    if backend == "host":
        sym, count, lit_len, lits, n_cmds, _, _ = _host_columns(buf, tlen)
        yd = torch.from_numpy(np.stack([
            np.pad(planar.host_decode_block(
                sym[b], count[b], lit_len[b], lits[b], int(n_cmds[b]),
                int(tlen[b])), (0, B - int(tlen[b])))
            for b in range(info.n_blocks)]))
    elif backend == "device":
        yd = device_ops.decode_blocks(planar.PlanarBlocks(
            *decode_sup.columns_to_device(_host_columns(buf, tlen), dev)))
    else:
        yd = _decode_packed(buf, info, blocks, tlen, dev, words)
    if w > 1:
        yd = _interleave(yd, orig_len, w)
    y = _to_host_bytes(yd, words)
    # only the last block can be partial (container.parse), so masking
    # each block to its length is one slice of the row-major rows
    return y.reshape(-1)[:info.uncompressed_size].tobytes()


def _host_columns(buf: bytes, tlen: np.ndarray) -> tuple:
    """The container unpacked on the host: ``(sym, count, lit_len, lits,
    n_cmds, n_lits, block_len)`` with the blocks' lane lengths ``tlen``."""
    _, cols = container.deserialize_to_planar(buf)
    return (*cols[:6], tlen)


def _decode_packed(buf: bytes, info, blocks, tlen: np.ndarray,
                   dev: torch.device, words: bool) -> torch.Tensor:
    """The kernel path: the packed sections shipped to ``dev``, unpacked,
    resolved (hrt1_unpack_resolve) and decoded (hrt1_decode) there."""
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
            return yd
    # non-uniform bit widths (pack_for_device -> None) or a flagged
    # container: unpack on the host, decode the columns on the device
    return decode_sup.decode_columns_device(
        *decode_sup.columns_to_device(_host_columns(buf, tlen), dev),
        block_size=info.block_size, out_words=words)


def _resolve(codec) -> spec_mod.CodecSpec:
    if isinstance(codec, spec_mod.CodecSpec):
        return codec
    if isinstance(codec, int):
        return spec_mod.by_index(codec)
    return spec_mod.by_name(codec)
