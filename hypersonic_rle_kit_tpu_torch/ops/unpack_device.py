"""Device-side container unpack: payload sections -> planar columns ->
decoded bytes.

Port of hypersonic_rle_kit_tpu/ops/unpack_device.py.  The host ships only
O(compressed) bytes -- the bit-packed count/lit_len sections, run symbols
and literal bytes, 128-padded per block (parallel/container.pack_for_device,
shared with the JAX package) -- in two buffers; on the device one kernel,
hrt1_unpack_resolve (``csrc/hrt1_unpack_resolve.cu``), bit-unpacks the
command columns, resolves the deep layout's escapes and symbol dictionary
and computes its ``bad`` flags, and hrt1_decode (ops/decode_sup.py) decodes.
The JAX package's section-level entry points are here with its arguments
(``decode_payload_device`` for the flat layout, ``decode_deep_device`` for
the deep one); ``dispatch_packed`` picks one for a pack, four device
operations (the unpack launch, the zeroing of hrt1_decode's look-back state
and its two grids).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import container
from . import _kernels, decode_sup

_I32 = torch.int32
_U8 = torch.uint8
MAX_WIDTH = 25      # a value and its in-byte shift fit a 32-bit window
LUT_BITS = 3

SECTION_KEYS = ("cnts_raw", "lls_raw", "syms", "lits", "cnt_ovf_raw",
                "ll_ovf_raw", "lut_raw", "miss_raw", "dict7",
                "n_cmds", "n_lits", "block_len",
                "n_cnt_ovf", "n_ll_ovf", "n_miss")
_SCALAR_KEYS = ("n_cmds", "n_lits", "block_len",
                "n_cnt_ovf", "n_ll_ovf", "n_miss")


def _check_width(S: int, width: int, n: int) -> None:
    """Raise ValueError unless a section row of ``S`` bytes holds ``n``
    values of ``width`` bits and the 4-byte window of the last one."""
    if width == 0:
        return
    if width > MAX_WIDTH or n % 8:
        raise ValueError(f"unpack needs width <= {MAX_WIDTH} and n % 8 == 0, "
                         f"got width={width} n={n}")
    last = ((7 * width) >> 3) + 3 + (n // 8 - 1) * width + 1  # phase 7, byte 3
    if 8 * S < n * width or last > S:
        raise ValueError(f"section of {S} bytes too short for {n} values "
                         f"of {width} bits")


def _unpack_wide(packed: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """[nb, S] packed uint8 -> [nb, n] int32 values of ``width`` bits
    (little-endian bit order, matching container._bitpack).

    Value ``8k + j`` starts at byte ``k*width + (j*width >> 3)`` with a
    fixed in-byte shift per phase j, so each of the 8 phases is four
    strided slices of the byte stream assembled into a 32-bit window.
    Requires width <= 25, n % 8 == 0 and 4 bytes of zero padding after
    the section (container.pack_for_device pads every section)."""
    nb, S = packed.shape
    if width == 0:
        return torch.zeros((nb, n), dtype=_I32, device=packed.device)
    _check_width(S, width, n)
    m = n // 8
    mask = (1 << width) - 1
    pw = packed.to(_I32)
    phases = []
    for j in range(8):
        b0 = (j * width) >> 3
        sh = (j * width) & 7
        word = torch.zeros((nb, m), dtype=_I32, device=packed.device)
        for t in range(4):
            start = b0 + t
            limit = start + (m - 1) * width + 1
            word = word | (pw[:, start:limit:width] << (8 * t))
        phases.append((word >> sh) & mask)
    return torch.stack(phases, dim=-1).reshape(nb, n)


def _escape_esc(bits: int) -> int:
    return (1 << bits) - 1 if bits else -1


def resolve_deep_plain(cnt_vals, cnt_ovf, ll_vals, ll_ovf, lut, miss, dict7,
                       n_cmds, *, cap: int, cnt_bits: int, lit_bits: int,
                       min_count: int):
    """The deep resolver on unpacked [nb, cap] columns, plain torch (cumsum
    ranks + gathers): the function of the JAX package's Pallas resolver
    (_resolve_deep).  ``cnt_bits``/``lit_bits`` of 0 disable that column's
    escapes.  Returns (count i32, lit_len i32, sym u8)."""
    idx = torch.arange(cap, dtype=_I32, device=cnt_vals.device)[None, :]
    nc = n_cmds.to(_I32)[:, None]
    is_run = idx < nc - 1
    is_cmd = idx < nc

    def distribute(base, ovf, esc_mask):
        em = esc_mask.to(_I32)
        rank = torch.cumsum(em, 1, dtype=_I32) - em
        pulled = ovf.gather(1, rank.clamp(max=ovf.shape[1] - 1).long())
        return torch.where(esc_mask, pulled.to(_I32), base)

    cesc, lesc = _escape_esc(cnt_bits), _escape_esc(lit_bits)
    cnt = cnt_vals
    if cesc >= 0:
        cnt = distribute(cnt, cnt_ovf, is_run & (cnt == cesc))
    count = torch.where(is_run, cnt + min_count, 0).to(_I32)
    ll = ll_vals
    if lesc >= 0:
        ll = distribute(ll, ll_ovf, is_cmd & (ll == lesc))
    lit_len = torch.where(is_cmd, ll, 0).to(_I32)

    hit = (lut >= 1) & (lut <= 7)
    sym = torch.where(hit, dict7.to(_I32).gather(1, (lut - 1).clamp(0, 6)
                                                 .long()), 0)
    sym = distribute(sym, miss, is_run & (lut == 0))
    return count, lit_len, sym.to(_U8)


def _check_sections(cnts_raw, lls_raw, n_cmds, deep: dict, *, cnt_bits,
                    lit_bits, cnt_ovf_bits, ll_ovf_bits, capacity) -> None:
    """Raise ValueError unless the sections are contiguous tensors of the
    right dtypes and shapes on one device, each long enough for
    ``capacity`` values of its width.  Shapes only: no device sync."""
    dev = cnts_raw.device if isinstance(cnts_raw, torch.Tensor) else None
    nb = n_cmds.shape[0] if isinstance(n_cmds, torch.Tensor) else -1
    cap = capacity
    if not 0 <= cap < 1 << 31 or cap % 8:   # 8 entries a kernel thread
        raise ValueError(f"unpack needs 0 <= n < 2^31 and n % 8 == 0, got "
                         f"n={cap}")
    rows = (("cnts_raw", cnts_raw, cnt_bits), ("lls_raw", lls_raw, lit_bits))
    want = [("n_cmds", n_cmds, _I32, (nb,))]
    if deep:
        rows += (("cnt_ovf_raw", deep["cnt_ovf_raw"], cnt_ovf_bits),
                 ("ll_ovf_raw", deep["ll_ovf_raw"], ll_ovf_bits),
                 ("lut_raw", deep["lut_raw"], LUT_BITS))
        want += [("miss_raw", deep["miss_raw"], _U8, (nb, cap)),
                 ("dict7", deep["dict7"], _U8, (nb, 7))]
        want += [(k, deep[k], _I32, (nb,))
                 for k in ("n_cnt_ovf", "n_ll_ovf", "n_miss")
                 if deep[k] is not None]
    want += [(k, t, _U8, (nb, getattr(t, "shape", (0, -1))[-1]))
             for k, t, _ in rows]
    for name, t, dtype, shape in want:
        if (not isinstance(t, torch.Tensor) or t.device != dev
                or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {dev}, got "
                f"{getattr(t, 'dtype', type(t))} "
                f"{tuple(getattr(t, 'shape', ()))} on "
                f"{getattr(t, 'device', None)}")
    for name, t, width in rows:
        if width < 0 or t.shape[1] >= 1 << 31:
            raise ValueError(f"{name}: width {width} or row of "
                             f"{t.shape[1]} bytes out of range")
        _check_width(t.shape[1], width, cap)


def _deep_sections(cnt_ovf_raw, ll_ovf_raw, lut_raw, miss_raw, dict7,
                   n_cnt_ovf, n_ll_ovf, n_miss) -> dict:
    if lut_raw is None:
        return {}
    return dict(cnt_ovf_raw=cnt_ovf_raw, ll_ovf_raw=ll_ovf_raw,
                lut_raw=lut_raw, miss_raw=miss_raw, dict7=dict7,
                n_cnt_ovf=n_cnt_ovf, n_ll_ovf=n_ll_ovf, n_miss=n_miss)


def unpack_resolve_plain(cnts_raw, lls_raw, n_cmds, cnt_ovf_raw=None,
                         ll_ovf_raw=None, lut_raw=None, miss_raw=None,
                         dict7=None, n_cnt_ovf=None, n_ll_ovf=None,
                         n_miss=None, *, cnt_bits: int, lit_bits: int,
                         cnt_ovf_bits: int = 0, ll_ovf_bits: int = 0,
                         capacity: int, min_count: int):
    """Plain torch version of the hrt1_unpack_resolve kernel, on any
    device: :func:`_unpack_wide` of each section, then
    :func:`resolve_deep_plain` and the ``bad`` flag sums (deep layout), or
    the flat layout's count / lit_len.  Same arguments and results as
    :func:`unpack_resolve`."""
    deep = _deep_sections(cnt_ovf_raw, ll_ovf_raw, lut_raw, miss_raw, dict7,
                          n_cnt_ovf, n_ll_ovf, n_miss)
    _check_sections(cnts_raw, lls_raw, n_cmds, deep, cnt_bits=cnt_bits,
                    lit_bits=lit_bits, cnt_ovf_bits=cnt_ovf_bits,
                    ll_ovf_bits=ll_ovf_bits, capacity=capacity)
    cap = capacity
    cnt_vals = _unpack_wide(cnts_raw, cnt_bits, cap)
    ll_vals = _unpack_wide(lls_raw, lit_bits, cap)
    idx = torch.arange(cap, dtype=_I32, device=cnts_raw.device)[None, :]
    is_run = idx < n_cmds[:, None] - 1
    is_cmd = idx < n_cmds[:, None]
    if not deep:
        count = torch.where(is_run, cnt_vals + min_count, 0).to(_I32)
        lit_len = torch.where(is_cmd, ll_vals, 0).to(_I32)
        return count, lit_len, None, None
    lut = _unpack_wide(lut_raw, LUT_BITS, cap)
    bad = torch.zeros(n_cmds.shape[0], dtype=_I32, device=cnts_raw.device)
    if n_cnt_ovf is not None and cnt_bits:
        actual = (is_run & (cnt_vals == (1 << cnt_bits) - 1)).sum(1)
        bad = bad | (actual != n_cnt_ovf).to(_I32)
    if n_ll_ovf is not None and lit_bits:
        actual = (is_cmd & (ll_vals == (1 << lit_bits) - 1)).sum(1)
        bad = bad | (actual != n_ll_ovf).to(_I32)
    if n_miss is not None:
        actual = (is_run & (lut == 0)).sum(1)
        bad = bad | (actual != n_miss).to(_I32)
    count, lit_len, sym = resolve_deep_plain(
        cnt_vals, _unpack_wide(cnt_ovf_raw, cnt_ovf_bits, cap), ll_vals,
        _unpack_wide(ll_ovf_raw, ll_ovf_bits, cap), lut, miss_raw, dict7,
        n_cmds, cap=cap, cnt_bits=cnt_bits if cnt_ovf_bits else 0,
        lit_bits=lit_bits if ll_ovf_bits else 0, min_count=min_count)
    return count, lit_len, sym, bad


def unpack_resolve(cnts_raw, lls_raw, n_cmds, cnt_ovf_raw=None,
                   ll_ovf_raw=None, lut_raw=None, miss_raw=None, dict7=None,
                   n_cnt_ovf=None, n_ll_ovf=None, n_miss=None, *,
                   cnt_bits: int, lit_bits: int, cnt_ovf_bits: int = 0,
                   ll_ovf_bits: int = 0, capacity: int, min_count: int):
    """Packed command sections -> (count i32, lit_len i32, sym u8, bad i32):
    count, lit_len and sym ``[nb, capacity]``, zero past the command range
    (sym: past the dictionary hits and misses), bad ``[nb]``.

    The deep layout passes ``lut_raw`` and with it ``cnt_ovf_raw``,
    ``ll_ovf_raw``, ``miss_raw``, ``dict7`` and the stored populations
    ``n_cnt_ovf``/``n_ll_ovf``/``n_miss`` (each may be None); ``bad[b] !=
    0`` marks a block whose stored populations disagree with its escapes.
    The flat layout (``lut_raw`` None) returns sym and bad as None.
    Sections are contiguous ``[nb, S]`` uint8 rows (pack_for_device's);
    a width above 25, a capacity that is no multiple of 8 or a section too
    short raises ValueError.  CUDA tensors launch the hrt1_unpack_resolve
    kernel, CPU tensors take :func:`unpack_resolve_plain`; anything else
    raises."""
    deep = _deep_sections(cnt_ovf_raw, ll_ovf_raw, lut_raw, miss_raw, dict7,
                          n_cnt_ovf, n_ll_ovf, n_miss)
    kw = dict(cnt_bits=cnt_bits, lit_bits=lit_bits,
              cnt_ovf_bits=cnt_ovf_bits, ll_ovf_bits=ll_ovf_bits,
              capacity=capacity)
    dev = cnts_raw.device
    if dev.type == "cpu":
        return unpack_resolve_plain(cnts_raw, lls_raw, n_cmds, **deep, **kw,
                                    min_count=min_count)
    if dev.type != "cuda":
        raise ValueError(f"hrt1_unpack_resolve runs on CUDA or CPU tensors, "
                         f"not {dev}")
    _check_sections(cnts_raw, lls_raw, n_cmds, deep, **kw)
    nb, cap = n_cmds.shape[0], capacity
    count = torch.empty((nb, cap), dtype=_I32, device=dev)
    lit_len = torch.empty((nb, cap), dtype=_I32, device=dev)
    sym = bad = None
    if deep:
        sym = torch.empty((nb, cap), dtype=_U8, device=dev)
        bad = torch.empty(nb, dtype=_I32, device=dev)

    def p(t):
        return None if t is None else _kernels.ptr(t)

    def s(t):
        return 0 if t is None else t.shape[1]

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernels.lib().hrt1_unpack_resolve(
            p(cnts_raw), p(lls_raw), p(cnt_ovf_raw), p(ll_ovf_raw),
            p(lut_raw), p(miss_raw), p(dict7), p(n_cmds), p(n_cnt_ovf),
            p(n_ll_ovf), p(n_miss), p(count), p(lit_len), p(sym), p(bad),
            nb, cap, s(cnts_raw), s(lls_raw), s(cnt_ovf_raw), s(ll_ovf_raw),
            s(lut_raw), cnt_bits, lit_bits, cnt_ovf_bits if deep else 0,
            ll_ovf_bits if deep else 0, min_count, stream)
    _kernels.check(rc, "hrt1_unpack_resolve")
    _kernels.count_launch("hrt1_unpack_resolve")
    return count, lit_len, sym, bad


def section_args(pk: dict, arrs: dict):
    """:func:`unpack_resolve`'s ``(args, kwargs)`` for a pack_for_device
    dict and its sections as tensors (``arrs``, ship_packed's)."""
    info = pk["info"]
    kw = dict(cnt_bits=pk["cnt_bits"], lit_bits=pk["lit_bits"],
              capacity=pk["capacity"], min_count=info.min_count)
    if info.deep:
        kw.update(cnt_ovf_bits=pk["cnt_ovf_bits"],
                  ll_ovf_bits=pk["ll_ovf_bits"],
                  **{k: arrs.get(k) for k in (
                      "cnt_ovf_raw", "ll_ovf_raw", "lut_raw", "miss_raw",
                      "dict7", "n_cnt_ovf", "n_ll_ovf", "n_miss")})
    return (arrs["cnts_raw"], arrs["lls_raw"], arrs["n_cmds"]), kw


def decode_payload_device(cnts_raw, lls_raw, syms, lits, n_cmds, n_lits,
                          block_len, *, cnt_bits: int, lit_bits: int,
                          capacity: int, block_size: int, min_count: int,
                          out_words: bool = False) -> torch.Tensor:
    """Flat-layout payload sections -> decoded ``[nb, block_size]`` uint8
    (or int32 words with ``out_words``): :func:`unpack_resolve` bit-unpacks
    the command columns, then hrt1_decode (``decode_sup``) decodes.  CUDA
    tensors launch the two kernels, CPU tensors take their plain versions;
    the sections are ship_packed's (contiguous, int32 counts)."""
    count, lit_len, _, _ = unpack_resolve(
        cnts_raw, lls_raw, n_cmds, cnt_bits=cnt_bits, lit_bits=lit_bits,
        capacity=capacity, min_count=min_count)
    return decode_sup.decode_columns_device(
        syms, count, lit_len, lits, n_cmds, n_lits, block_len,
        block_size=block_size, out_words=out_words)


def decode_deep_device(cnts_raw, cnt_ovf_raw, lls_raw, ll_ovf_raw, lut_raw,
                       miss_raw, dict7, lits, n_cmds, n_lits, block_len,
                       n_cnt_ovf=None, n_ll_ovf=None, n_miss=None, *,
                       cnt_bits: int, lit_bits: int, cnt_ovf_bits: int,
                       ll_ovf_bits: int, capacity: int, block_size: int,
                       min_count: int, out_words: bool = False):
    """Deep-layout payload sections -> ``(decoded bytes, bad flags)``:
    :func:`unpack_resolve` resolves the two-tier count / lit_len escapes
    and the symbol dictionary and misses, then hrt1_decode decodes.

    ``bad[b] != 0`` marks a block whose stored escape / miss counts
    (``n_cnt_ovf``, ``n_ll_ovf``, ``n_miss``; each may be None) disagree
    with its escape population: a hostile container, which callers send to
    the validating host reader (ContainerError).  CUDA tensors launch the
    two kernels, CPU tensors take their plain versions."""
    count, lit_len, sym, bad = unpack_resolve(
        cnts_raw, lls_raw, n_cmds, cnt_ovf_raw, ll_ovf_raw, lut_raw,
        miss_raw, dict7, n_cnt_ovf, n_ll_ovf, n_miss, cnt_bits=cnt_bits,
        lit_bits=lit_bits, cnt_ovf_bits=cnt_ovf_bits,
        ll_ovf_bits=ll_ovf_bits, capacity=capacity, min_count=min_count)
    out = decode_sup.decode_columns_device(
        sym, count, lit_len, lits, n_cmds, n_lits, block_len,
        block_size=block_size, out_words=out_words)
    return out, bad


def dispatch_packed(pk: dict, arrs: dict, *, with_flags: bool = False,
                    out_words: bool = False):
    """Run the right device decode for a pack_for_device dict whose array
    members (``SECTION_KEYS`` subset) are already tensors in ``arrs``
    (ship_packed): :func:`decode_deep_device` or
    :func:`decode_payload_device`.  Returns the output tensor; with
    ``with_flags`` returns ``(out, bad)`` where ``bad`` is the deep
    layout's per-block sub-header-mismatch flag vector (None for flat
    containers)."""
    info = pk["info"]
    kw = dict(cnt_bits=pk["cnt_bits"], lit_bits=pk["lit_bits"],
              capacity=pk["capacity"], block_size=info.block_size,
              min_count=info.min_count, out_words=out_words)
    if info.deep:
        out, bad = decode_deep_device(
            arrs["cnts_raw"], arrs["cnt_ovf_raw"], arrs["lls_raw"],
            arrs["ll_ovf_raw"], arrs["lut_raw"], arrs["miss_raw"],
            arrs["dict7"], arrs["lits"], arrs["n_cmds"], arrs["n_lits"],
            arrs["block_len"], arrs.get("n_cnt_ovf"), arrs.get("n_ll_ovf"),
            arrs.get("n_miss"), cnt_ovf_bits=pk["cnt_ovf_bits"],
            ll_ovf_bits=pk["ll_ovf_bits"], **kw)
    else:
        out, bad = decode_payload_device(
            arrs["cnts_raw"], arrs["lls_raw"], arrs["syms"], arrs["lits"],
            arrs["n_cmds"], arrs["n_lits"], arrs["block_len"], **kw), None
    return (out, bad) if with_flags else out


def decode_packed(pk: dict, *, device="cuda") -> np.ndarray:
    """Host convenience wrapper: pack_for_device dict -> [nb, B] bytes,
    decoded on ``device`` (the card unless the caller asks for the CPU).

    Raises ContainerError when the deep sub-header counts disagree with
    the actual escape population (hostile input)."""
    out, bad = dispatch_packed(pk, ship_packed(pk, device), with_flags=True)
    if bad is not None and bool(bad.any()):
        raise container.ContainerError(
            "deep block: sub-header escape/miss counts disagree with the "
            "escape population")
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# shipping: all payload sections in two concatenated host buffers (uint8
# sections; int32 sections incl. the literal words), one host-to-device copy
# each, then views at static offsets
# ---------------------------------------------------------------------------

def _ship_layout(pk: dict):
    """pack_for_device dict -> (u8 parts, i32 parts, manifest)."""
    u8_parts, i32_parts, manifest = [], [], []
    u8_off = i32_off = 0
    for k in SECTION_KEYS:
        if k not in pk:
            continue
        a = pk[k]
        if a.ndim == 1:
            a = a.reshape(1, -1)
        nb, w = a.shape
        if a.dtype == np.uint8:
            u8_parts.append(np.ascontiguousarray(a).reshape(-1))
            manifest.append((k, 0, nb, w, u8_off))
            u8_off += nb * w
        else:
            i32_parts.append(np.ascontiguousarray(
                a.astype(np.int32, copy=False)).reshape(-1))
            manifest.append((k, 1, nb, w, i32_off))
            i32_off += nb * w
    return u8_parts, i32_parts, tuple(manifest)


def build_ship_buffers(pk: dict):
    """pack_for_device dict -> (u8_buf, i32_buf, manifest), numpy.

    ``manifest`` is a tuple of (key, kind, nb, width, offset) where kind 0
    = uint8 section in u8_buf, 1 = int32 section in i32_buf; offsets are in
    elements of the owning buffer."""
    u8_parts, i32_parts, manifest = _ship_layout(pk)
    u8 = np.concatenate(u8_parts) if u8_parts else np.zeros(128, np.uint8)
    i32 = np.concatenate(i32_parts) if i32_parts else np.zeros(128, np.int32)
    return u8, i32, manifest


def _host_buffer(parts, dtype, pin: bool) -> torch.Tensor:
    n = sum(p.size for p in parts) or 128
    buf = torch.zeros(n, dtype=dtype, pin_memory=pin)
    if parts:
        np.concatenate(parts, out=buf.numpy()[:n])
    return buf


def ship_packed(pk: dict, device="cuda") -> dict:
    """Host pack dict (container.pack_for_device, unchanged) -> the port's
    section tensors on ``device`` (the card unless the caller asks for the
    CPU).  On CUDA the sections are concatenated into two pinned host
    buffers, each sent with one non-blocking copy on the current stream;
    the sections are views of the two device buffers at the manifest's
    static offsets."""
    dev = torch.device(device)
    pin = dev.type == "cuda"
    u8_parts, i32_parts, manifest = _ship_layout(pk)
    bufs = (_host_buffer(u8_parts, torch.uint8, pin),
            _host_buffer(i32_parts, torch.int32, pin))
    bufs = tuple(b.to(dev, non_blocking=pin) for b in bufs)
    out = {}
    for k, kind, nb, w, off in manifest:
        sec = bufs[kind][off:off + nb * w].view(nb, w)
        out[k] = sec[0] if k in _SCALAR_KEYS else sec
    return out
