"""Build the CUDA kernels of the package with nvcc and load them with ctypes.

Each `.cu` in this directory is compiled on first use into a shared library
with a plain C interface:

    nvcc -O3 -std=c++17 -shared -Xcompiler -fPIC \
         -gencode arch=compute_90a,code=sm_90a -o _build/lib<name>_<hash>.so <name>.cu

The file name carries a hash of the source and the flags, so an edited source
is rebuilt. Nothing here needs ninja or PyTorch's headers. A failed build
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library -> {exported function: (restype, argtypes)}; pointers and the
# stream are c_void_p, so that ctypes never cuts them to 32 bits
SIGNATURES = {
    "flash_attn_fwd": {
        "cgic_flash_attn_fwd": (_I, [_P] * 6 + [_I] * 6
                                + [ctypes.c_float, _P]),
        "cgic_flash_attn_splits": (_I, [_I] * 5),
    },
    "flash_attn_bwd": {
        "cgic_flash_attn_bwd_dkdv": (_I, [_P] * 9 + [_I] * 5
                                     + [ctypes.c_float, _P]),
        "cgic_flash_attn_bwd_dq": (_I, [_P] * 7 + [_I] * 5
                                   + [ctypes.c_float, _P]),
    },
    "norm_conv_chain": {
        "cgic_norm_conv_chain": (_I, [_P] * 15 + [_I] * 9 + [_P]),
        "cgic_norm_conv_chain_block_n": (_I, [_I, _I]),
        "cgic_norm_conv_chain_tiles": (_I, [_I] * 4),
    },
    # one block of int64 arguments (ops/fused_norm.py::_launch)
    "gn_moments": {"cgic_gn_moments": (_I, [_P])},
    "spatial_norm_apply": {"cgic_spatial_norm_apply": (_I, [_P])},
    "huffman_scan": {"cgic_huffman_scan": (_I, [_P] * 5 + [_I] * 4 + [_P])},
}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[tuple, ctypes._CFuncPtr] = {}
# name -> (seconds, ptxas report) of the builds this process ran
BUILD_LOG: Dict[str, tuple] = {}
# the counters of this process that count at call time (`counter`): a
# replayed CUDA graph calls no wrapper, so its program adds to each what its
# capture counted (utils/programs.Program)
COUNTERS: List[dict] = []


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> str:
    with open(os.path.join(KERNEL_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str, nvcc: Optional[str] = None) -> str:
    """Compile kernels/<name>.cu unless its library is already built; returns
    the library's path. Raises RuntimeError with nvcc's output on failure."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(KERNEL_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernels/<name>.cu, built on first use, with the
    types of its functions declared (SIGNATURES)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            sigs = {**SIGNATURES[name],
                    "cgic_cuda_error_string": (ctypes.c_char_p, [_I])}
            for fn, (restype, argtypes) in sigs.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return lib


def function(name: str, fn: str) -> ctypes._CFuncPtr:
    """The exported function `fn` of kernels/<name>.cu's library, with its
    types declared: looked up under load()'s lock on the first call only, so
    that a wrapper on a hot path takes no lock."""
    f = _FUNCTIONS.get((name, fn))
    if f is None:
        f = _FUNCTIONS[name, fn] = getattr(load(name), fn)
    return f


def counter(counts: dict) -> dict:
    """Add `counts` to COUNTERS and return it."""
    COUNTERS.append(counts)
    return counts


def count_launch(counts: dict, key: str) -> None:
    """Add one launch to counts[key]. Kernels launch from several threads in
    the pipelined codec, and `+=` on a dict item is a read, an add and a
    write, so the count is taken under a lock (uncontended: well under a
    microsecond)."""
    with _COUNT_LOCK:
        counts[key] += 1


def add_launches(counts: dict, delta: dict) -> None:
    """Add delta[key] launches to counts[key] for each key, under
    count_launch's lock: a replayed CUDA graph runs no wrapper, so its
    program adds the launches its capture counted
    (utils/programs.Program)."""
    with _COUNT_LOCK:
        for key, n in delta.items():
            counts[key] += n


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise unless a launcher's return code is 0 (a cudaError_t code > 0,
    -1 for arguments the kernel refused)."""
    if rc != 0:
        why = (lib.cgic_cuda_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"{name} launch failed ({rc}): {why}")
