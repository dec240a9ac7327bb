"""Build and load the hand-written Hopper kernels (``../csrc/*.cu``).

The sources are compiled with ``nvcc``, one process per source, all started
together, and linked into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), at first use, into
``build/torch_kernels/`` under the repository root, keyed by a hash of the
sources and flags.  The library is loaded with ``ctypes``: every pointer
and the stream pass as ``c_void_p``, and every entry point returns
``cudaGetLastError()`` right after its launch.

Each kernel wrapper counts its launches here (``count_launch``), so a run
can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("hrt1_decode.cu", "hrt1_resolve.cu", "hrt1_encode.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
KERNELS = ("hrt1_decode", "hrt1_resolve_deep", "hrt1_encode")

_launches = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin): the Hopper "
                       "kernels are built from csrc/*.cu at first use")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update((_CSRC / s).read_bytes())
    return _BUILD / f"libhrt1_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with nvcc's diagnostics if any
    fails (after all have ended)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"{' '.join(c)} -> {p.returncode}:\n{o}"
           for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(bad))


def build() -> None:
    """Compile the sources into :func:`library_path`; raises with nvcc's
    diagnostics on a failed build."""
    so = library_path()
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [so.with_name(f"{tag}.{s}.o") for s in SOURCES]
    tmp = so.with_name(f"{tag}.so.tmp")
    nvcc = _nvcc()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
              for s, o in zip(SOURCES, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, so)      # atomic: concurrent builds race safely
    finally:
        for o in (*objs, tmp):
            o.unlink(missing_ok=True)


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    so = library_path()
    if not so.exists():
        build()
    L = ctypes.CDLL(str(so))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    L.hrt1_decode.argtypes = [p, p, p, p, p, p, p, p,
                              i64, i32, i32, i32, i32, p]
    L.hrt1_decode.restype = ctypes.c_int
    L.hrt1_resolve_deep.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                    i64, i32, i32, i32, i32, p]
    L.hrt1_resolve_deep.restype = ctypes.c_int
    L.hrt1_encode.argtypes = [p, p, p, p, p, p, p, p, p, p,
                              i64, i32, i32, i32, i32, p]
    L.hrt1_encode.restype = ctypes.c_int
    L.hrt1_error_string.argtypes = [ctypes.c_int]
    L.hrt1_error_string.restype = ctypes.c_char_p
    return L


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = lib().hrt1_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
