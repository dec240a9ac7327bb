"""Build and load the hand-written Hopper kernels (``../csrc/*.cu``).

The sources are compiled with ``nvcc``, one process per source, all started
together, and linked into shared libraries with a plain C interface (no
PyTorch headers, so a build takes seconds), at first use, into
``build/torch_kernels/`` under the repository root, each keyed by a hash of
its sources and flags.  There are two libraries: ``hrt1``, the codec's
kernels, and ``micro_word``, the word microbenchmark's, so the codec never
builds or loads the benchmark's code.  A library is loaded with ``ctypes``:
every pointer and the stream pass as ``c_void_p``, and every entry point
returns ``cudaGetLastError()`` right after its launch.

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
# library -> its sources; each library exports <library>_error_string
LIBRARIES = {"hrt1": ("hrt1_decode.cu", "hrt1_unpack_resolve.cu",
                      "hrt1_encode.cu", "mmtf.cu"),
             "micro_word": ("micro_word.cu",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# entry point -> (library, argtypes); each returns a cudaError_t as int
_ENTRY = {
    "hrt1_decode": ("hrt1", [_P] * 9 + [_I64, _I32, _I32, _I32, _I32, _P]),
    "hrt1_unpack_resolve": ("hrt1", [_P] * 15 + [_I64] + [_I32] * 11 + [_P]),
    "hrt1_encode": ("hrt1", [_P] * 10 + [_I64, _I32, _I32, _I32, _I32, _P]),
    "mmtf_scan": ("hrt1", [_P] * 4 + [_I64, _I64, _I32, _I32, _I32, _P]),
    "word_slice_sum": ("micro_word", [_P, _P, _I64, _I32, _P]),
    "word_sampled_prefix": ("micro_word", [_P, _P, _I64, _P]),
}

# size helpers: name -> (library, argtypes); each returns an int64
_SIZES = {
    "hrt1_encode_state_ints": ("hrt1", [_I64, _I32]),
    "hrt1_decode_scratch_ints": ("hrt1", [_I64, _I32, _I32]),
    "hrt1_decode_state_ints": ("hrt1", [_I64, _I32]),
    "mmtf_scan_scratch_ints": ("hrt1", [_I64, _I64, _I32, _I32, _I32]),
}

_launches = dict.fromkeys(_ENTRY, 0)


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


def library_path(name: str = "hrt1") -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in LIBRARIES[name]:
        h.update((_CSRC / s).read_bytes())
    return _BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


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


def build(*names: str) -> None:
    """Compile the named libraries (all by default) into
    :func:`library_path`, every source at once; raises with nvcc's
    diagnostics on a failed build."""
    names = names or tuple(LIBRARIES)
    nvcc = _nvcc()
    sos = {n: library_path(n) for n in names}
    tmps = {n: so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
            for n, so in sos.items()}
    objs = {n: [so.with_name(f"{so.stem}.{os.getpid()}.{s}.o")
                for s in LIBRARIES[n]] for n, so in sos.items()}
    _BUILD.mkdir(parents=True, exist_ok=True)
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
              for n in names for s, o in zip(LIBRARIES[n], objs[n])])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmps[n]),
               *map(str, objs[n])] for n in names])
        for n in names:       # atomic: concurrent builds race safely
            os.replace(tmps[n], sos[n])
    finally:
        for n in names:
            for f in (*objs[n], tmps[n]):
                f.unlink(missing_ok=True)


@functools.cache
def lib(name: str = "hrt1") -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    so = library_path(name)
    if not so.exists():
        build(name)
    L = ctypes.CDLL(str(so))
    for entry, (owner, argtypes) in _ENTRY.items():
        if owner == name:
            fn = getattr(L, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    for entry, (owner, argtypes) in _SIZES.items():
        if owner == name:
            fn = getattr(L, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int64
    err = getattr(L, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return L


def check(rc: int, name: str) -> None:
    """Raise if a launch of kernel ``name`` reported a CUDA error."""
    if rc != 0:
        owner = _ENTRY[name][0]
        msg = getattr(lib(owner), f"{owner}_error_string")(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
