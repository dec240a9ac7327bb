"""ctypes bindings for the C++ host runtime (csrc/hsrk_host.cpp).

Built lazily with g++ from the port's own ``csrc/hsrk_host.cpp`` into
``build/torch_host/libhsrk_host.so`` under the repository root (the JAX
package builds its copy into ``build/`` beside it, so the two never share
a library); every entry point has a numpy fallback so the package works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "hsrk_host.cpp"
_SO = _PKG.parent / "build" / "torch_host" / "libhsrk_host.so"

_lib = None
_tried = False


def _build() -> bool:
    """Compile into a per-process temporary and rename it into place, so
    processes that build at once (test workers) never load a half-written
    library."""
    import os
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False
    finally:
        tmp.unlink(missing_ok=True)


def disable() -> None:
    """Force the pure-Python tier (the --max-simd analog: the reference
    masks its CPU-feature globals after detection, main.c:172-282)."""
    global _lib, _tried
    _lib, _tried = None, True


def lib():
    """Load (building if needed) the native library; None if unavailable.
    ``HSRK_NO_NATIVE=1`` forces the pure-Python tier (the CI analog of the
    reference's --max-simd dispatch fault injection, gcc.yml:50-240)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    import os
    if os.environ.get("HSRK_NO_NATIVE") == "1":
        _tried = True
        return None
    _tried = True
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        L = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    i64, i32p, u8p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                      ctypes.POINTER(ctypes.c_uint8))
    L.decode_planar_batch.restype = ctypes.c_int
    L.planar_from_bytes.restype = ctypes.c_int
    L.planar_from_bytes_batch.restype = ctypes.c_int
    L.hsrk_rle8_compress.restype = ctypes.c_uint32
    L.hsrk_rle8_decompress.restype = ctypes.c_uint32
    L.unpack_container_batch.restype = ctypes.c_int
    L.hsrk_mmtf.restype = ctypes.c_int
    L.hsrk_le_decode.restype = ctypes.c_int
    L.hsrk_sh_decode.restype = ctypes.c_int
    L.hsrk_sh_encode.restype = ctypes.c_int64
    L.hsrk_short_greedy_encode.restype = ctypes.c_int64
    L.ref_parse_planar.restype = ctypes.c_int
    L.unpack_container_deep_batch.restype = ctypes.c_int
    L.resolve_litdict_batch.restype = ctypes.c_int
    _lib = L
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def planar_from_bytes(x: np.ndarray, lens: np.ndarray, cap: int,
                      min_count: int = 6, only_sym=None):
    """Native block encoder: [nb, B] bytes -> planar columns; None if the
    library is unavailable.  ``only_sym[nb]`` (or None) restricts emission
    per block (Single family)."""
    L = lib()
    if L is None:
        return None
    nb, B = x.shape
    sym = np.zeros((nb, cap), np.uint8)
    count = np.zeros((nb, cap), np.int32)
    lit_len = np.zeros((nb, cap), np.int32)
    lits = np.zeros((nb, B), np.uint8)
    n_cmds = np.zeros(nb, np.int32)
    n_lits = np.zeros(nb, np.int32)
    xc = np.ascontiguousarray(x, np.uint8)
    lc = np.ascontiguousarray(lens, np.int32)
    oc = (None if only_sym is None
          else np.ascontiguousarray(only_sym, np.int32))
    rc = L.planar_from_bytes_batch(
        _ptr(xc), _ptr(lc), ctypes.c_int64(nb), ctypes.c_int64(cap),
        ctypes.c_int64(B), ctypes.c_int32(min_count),
        _ptr(sym), _ptr(count), _ptr(lit_len), _ptr(lits),
        _ptr(n_cmds), _ptr(n_lits),
        None if oc is None else _ptr(oc))
    if rc != 0:
        raise RuntimeError(f"planar_from_bytes rc={rc}")
    return sym, count, lit_len, lits, n_cmds, n_lits


def decode_planar(sym, count, lit_len, lits, n_cmds, block_len):
    """Native threaded block decoder: planar columns -> [nb, B] bytes
    (zero past block_len); None if the library is unavailable."""
    L = lib()
    if L is None:
        return None
    nb, cap = count.shape
    B = lits.shape[1]
    out = np.empty((nb, B), np.uint8)
    args = [np.ascontiguousarray(sym, np.uint8),
            np.ascontiguousarray(count, np.int32),
            np.ascontiguousarray(lit_len, np.int32),
            np.ascontiguousarray(lits, np.uint8),
            np.ascontiguousarray(n_cmds, np.int32),
            np.ascontiguousarray(block_len, np.int32)]
    rc = L.decode_planar_batch(
        _ptr(args[0]), _ptr(args[1]), _ptr(args[2]), _ptr(args[3]),
        _ptr(args[4]), _ptr(args[5]),
        ctypes.c_int64(nb), ctypes.c_int64(cap), ctypes.c_int64(B),
        _ptr(out))
    if rc != 0:
        raise RuntimeError(f"decode_planar_batch failed rc={rc}")
    return out


def unpack_container(payload: np.ndarray, payload_off, n_cmds, n_lits,
                     cnt_bits, lit_bits, cap: int, B: int, min_count: int):
    """Native HRT1 payload -> padded planar columns; None if the library is
    unavailable.  ``payload`` is the raw container bytes as uint8; offsets
    are absolute into it.  Caller validates sizes (container.parse)."""
    L = lib()
    if L is None:
        return None
    nb = len(n_cmds)
    sym = np.empty((nb, cap), np.uint8)
    count = np.empty((nb, cap), np.int32)
    lit_len = np.empty((nb, cap), np.int32)
    lits = np.empty((nb, B), np.uint8)
    args = [np.ascontiguousarray(payload, np.uint8),
            np.ascontiguousarray(payload_off, np.int64),
            np.ascontiguousarray(n_cmds, np.int32),
            np.ascontiguousarray(n_lits, np.int32),
            np.ascontiguousarray(cnt_bits, np.int32),
            np.ascontiguousarray(lit_bits, np.int32)]
    rc = L.unpack_container_batch(
        _ptr(args[0]), _ptr(args[1]), _ptr(args[2]), _ptr(args[3]),
        _ptr(args[4]), _ptr(args[5]),
        ctypes.c_int64(nb), ctypes.c_int64(cap), ctypes.c_int64(B),
        ctypes.c_int32(min_count), _ptr(sym), _ptr(count), _ptr(lit_len),
        _ptr(lits))
    if rc != 0:
        raise RuntimeError(f"unpack_container_batch rc={rc}")
    return sym, count, lit_len, lits


def mmtf(data: bytes, lanes: int, encode: bool) -> bytes | None:
    """Native Multi-MTF transform (mmtf.c semantics); None if the library
    is unavailable."""
    L = lib()
    if L is None:
        return None
    inp = np.frombuffer(data, np.uint8)
    out = np.empty(inp.size, np.uint8)
    L.hsrk_mmtf(ctypes.c_void_p(inp.ctypes.data), ctypes.c_int64(inp.size),
                ctypes.c_int64(lanes), ctypes.c_int(1 if encode else 0),
                _ptr(out))
    return out.tobytes()


def le_decode_into(buf: bytes, p0: int, rle: np.ndarray, stc: np.ndarray,
                   out: np.ndarray, want: int):
    """Native Low Entropy body decode into ``out`` (a uint8 view with
    >= want + 255 bytes): returns (p_end, produced) -- ``produced`` may
    overshoot ``want`` by one trailing run, which rle8m sections carry --
    or None (library unavailable / truncated stream)."""
    L = lib()
    if L is None:
        return None
    inp = np.frombuffer(buf, np.uint8)
    p_end = ctypes.c_int64(0)
    o_end = ctypes.c_int64(0)
    rc = L.hsrk_le_decode(
        ctypes.c_void_p(inp.ctypes.data), ctypes.c_int64(inp.size),
        ctypes.c_int64(p0),
        _ptr(np.ascontiguousarray(rle, np.uint8)),
        _ptr(np.ascontiguousarray(stc, np.int32)),
        _ptr(out), ctypes.c_int64(want), ctypes.byref(p_end),
        ctypes.byref(o_end))
    if rc != 0:
        return None
    return int(p_end.value), int(o_end.value)


def sh_decode(buf: bytes, csize: int, usize: int) -> bytes | None:
    """Native RLE8-SH decode; None if unavailable or the stream is
    malformed (caller falls back to the golden Python decoder)."""
    L = lib()
    if L is None:
        return None
    inp = np.frombuffer(buf, np.uint8)
    cap = usize + (1 << 16)
    out = np.empty(cap, np.uint8)
    rc = L.hsrk_sh_decode(
        ctypes.c_void_p(inp.ctypes.data), ctypes.c_int64(csize),
        ctypes.c_int64(usize), _ptr(out), ctypes.c_int64(cap))
    if rc != 0:
        return None
    return out[:usize].tobytes()


def rle8_compress(data: bytes) -> bytes | None:
    L = lib()
    if L is None:
        return None
    n = len(data)
    out = np.zeros(n + 256, np.uint8)
    inp = np.frombuffer(data, np.uint8)
    r = L.hsrk_rle8_compress(ctypes.c_void_p(inp.ctypes.data),
                             ctypes.c_uint32(n), _ptr(out),
                             ctypes.c_uint32(out.size))
    return out[:r].tobytes() if r else b""


def rle8_decompress(buf: bytes) -> bytes | None:
    L = lib()
    if L is None:
        return None
    usize = int.from_bytes(buf[:4], "little")
    out = np.zeros(usize + 256, np.uint8)
    inp = np.frombuffer(buf, np.uint8)
    r = L.hsrk_rle8_decompress(ctypes.c_void_p(inp.ctypes.data),
                               ctypes.c_uint32(len(buf)), _ptr(out),
                               ctypes.c_uint32(out.size))
    return out[:r].tobytes() if r else b""


def ref_parse_planar(buf: bytes, family: int, width: int, flags: int,
                     lutsz: int, usize: int, block_size: int):
    """Native reference-stream grammar walk -> planar columns (two passes:
    count, then fill -- csrc ref_parse_planar).  Returns the planar tuple
    (sym, count, lit_len, lits, n_cmds, n_lits, block_len) in phase-major
    block order, plus blocks-per-phase; None if the library is unavailable
    or the walk fails (caller falls back to the Python walkers)."""
    L = lib()
    if L is None:
        return None
    s = 1 if family == 0 else (16 if family == 2 else width // 8)
    m = -(-usize // s)
    nbp = max(1, -(-m // block_size))
    nb = s * nbp
    bc = np.frombuffer(buf, np.uint8)
    n_cmds = np.zeros(nb, np.int32)
    n_lits = np.zeros(nb, np.int32)
    args0 = (_ptr(bc), ctypes.c_int64(len(buf)), ctypes.c_int(family),
             ctypes.c_int(width), ctypes.c_int(flags), ctypes.c_int(lutsz),
             ctypes.c_int64(usize), ctypes.c_int64(block_size))
    rc = L.ref_parse_planar(*args0, None, None, None, None,
                            _ptr(n_cmds), _ptr(n_lits),
                            ctypes.c_int(0), ctypes.c_int(0))
    if rc != 0:
        return None
    cap = max(128, -(-int(n_cmds.max()) // 128) * 128)
    lcap = max(128, -(-int(n_lits.max()) // 128) * 128)
    sym = np.zeros((nb, cap), np.uint8)
    count = np.zeros((nb, cap), np.int32)
    lit_len = np.zeros((nb, cap), np.int32)
    lits = np.zeros((nb, lcap), np.uint8)
    rc = L.ref_parse_planar(*args0, _ptr(sym), _ptr(count), _ptr(lit_len),
                            _ptr(lits), _ptr(n_cmds), _ptr(n_lits),
                            ctypes.c_int(cap), ctypes.c_int(lcap))
    if rc != 0:
        return None
    block_len = np.full(nb, block_size, np.int32)
    last = m - (nbp - 1) * block_size
    block_len[nbp - 1::nbp] = last
    return (sym, count, lit_len, lits, n_cmds, n_lits, block_len), nbp


def resolve_litdict(payload: np.ndarray, lit_off, n_lits, lit_k, n_lmiss,
                    L: int):
    """Native k-bit literal-dictionary resolution into a fresh [nb, L]
    byte plane; None if unavailable or inconsistent."""
    Lb = lib()
    if Lb is None:
        return None
    nb = len(n_lits)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    lits = np.empty((nb, L), np.uint8)
    rc = Lb.resolve_litdict_batch(
        _ptr(payload), _ptr(np.ascontiguousarray(lit_off, np.int64)),
        _ptr(i32(n_lits)), _ptr(i32(lit_k)), _ptr(i32(n_lmiss)),
        ctypes.c_int64(nb), ctypes.c_int64(L), _ptr(lits))
    if rc != 0:
        return None
    return lits


def sh_encode(data: bytes):
    """Native SH encoder fast tier (byte-exact vs formats/sh.py's golden
    Python encoder); None if the native runtime is unavailable."""
    L = lib()
    if L is None:
        return None
    n = len(data)
    if n == 0:
        return b""
    cap = 8 + 2 * n + 4096
    dst = np.empty(cap, np.uint8)
    src = np.frombuffer(data, np.uint8)
    total = L.hsrk_sh_encode(_ptr(src), ctypes.c_int64(n), _ptr(dst),
                             ctypes.c_int64(cap))
    if total <= 0:
        return None
    return dst[:total].tobytes()


def short_greedy_encode(arr: np.ndarray, width: int, sc: int):
    """Native Greedy Short encoder fast tier (byte-exact vs
    formats/short.py's golden Python encoder); None if unavailable."""
    L = lib()
    if L is None:
        return None
    n = int(arr.size)
    if n == 0:
        return b""
    cap = 8 + 2 * n + 4096
    dst = np.empty(cap, np.uint8)
    total = L.hsrk_short_greedy_encode(
        _ptr(np.ascontiguousarray(arr, np.uint8)), ctypes.c_int64(n),
        ctypes.c_int32(width), ctypes.c_int32(sc), _ptr(dst),
        ctypes.c_int64(cap))
    if total <= 0:
        return None
    return dst[:total].tobytes()


def unpack_container_deep(payload: np.ndarray, payload_off, n_cmds, n_lits,
                          cnt_bits, lit_bits, cnt_ovf_bits, ll_ovf_bits,
                          n_cnt_ovf, n_ll_ovf, n_miss, dict7,
                          hdr_size: int, capacity: int, B: int,
                          min_count: int, lit_k=None, n_lmiss=None):
    """Native deep-layout container unpack (csrc); None if unavailable or
    the native resolver flags an inconsistency (caller falls back to the
    validating Python reader)."""
    L = lib()
    if L is None:
        return None
    nb = len(n_cmds)
    sym = np.empty((nb, capacity), np.uint8)
    count = np.empty((nb, capacity), np.int32)
    lit_len = np.empty((nb, capacity), np.int32)
    lits = np.empty((nb, B), np.uint8)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    rc = L.unpack_container_deep_batch(
        _ptr(payload), _ptr(np.ascontiguousarray(payload_off, np.int64)),
        _ptr(i32(n_cmds)), _ptr(i32(n_lits)), _ptr(i32(cnt_bits)),
        _ptr(i32(lit_bits)), _ptr(i32(cnt_ovf_bits)), _ptr(i32(ll_ovf_bits)),
        _ptr(i32(n_cnt_ovf)), _ptr(i32(n_ll_ovf)), _ptr(i32(n_miss)),
        _ptr(np.ascontiguousarray(dict7, np.uint8)),
        ctypes.c_int64(hdr_size),
        _ptr(i32(lit_k)) if lit_k is not None else None,
        _ptr(i32(n_lmiss)) if n_lmiss is not None else None,
        ctypes.c_int64(nb),
        ctypes.c_int64(capacity), ctypes.c_int64(B),
        ctypes.c_int32(min_count),
        _ptr(sym), _ptr(count), _ptr(lit_len), _ptr(lits))
    if rc != 0:
        return None
    return sym, count, lit_len, lits
