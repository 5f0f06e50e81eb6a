"""Compiles and loads the C++ entropy coder through ctypes (port of
control_gic_tpu/coding/native_lib.py).

`native/entropy_codec.cpp` (the JAX package's source, byte-identical but
for one comment's path, as the tests hold) is built on first use with

    g++ -O3 -shared -fPIC -std=c++17 -o kernels/_build/libentropy_codec_<hash>.so

into the package's gitignored build directory; the name carries a hash of
the source and the flags, so an edited source is rebuilt. Without a compiler
`get_native()` returns None and the coders take their pure-Python paths, as
in JAX. A ctypes call releases the interpreter lock for its length, so the
coder runs beside a thread that launches device work.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_NATIVE = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "entropy_codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_i64 = ctypes.c_int64
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")


class NativeCodec:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.cgic_huff_encode.restype = _i64
        lib.cgic_huff_encode.argtypes = [
            _i32p, _i64, _u16p, _u8p, ctypes.c_int32, _u8p, _i64]
        lib.cgic_huff_decode.restype = _i64
        lib.cgic_huff_decode.argtypes = [
            _u8p, _i64, _i32p, ctypes.c_int32, ctypes.c_void_p, _i32p, _i64]
        lib.cgic_huff_lut_size.restype = _i64
        lib.cgic_huff_lut_size.argtypes = []
        lib.cgic_huff_build_lut.restype = None
        lib.cgic_huff_build_lut.argtypes = [_i32p, ctypes.c_int32, _i32p]
        lib.cgic_bitmap_encode.restype = _i64
        lib.cgic_bitmap_encode.argtypes = [_u8p, _i64, _u8p, _i64]
        lib.cgic_bitmap_decode.restype = _i64
        lib.cgic_bitmap_decode.argtypes = [_u8p, _i64, _u8p, _i64]

    def huff_encode(self, symbols: np.ndarray, lens: np.ndarray,
                    code_bytes: np.ndarray) -> Optional[bytes]:
        n = symbols.size
        max_bits = int(lens.max()) if lens.size else 0
        cap = 2 + (n * max_bits + 7) // 8 + 8
        out = np.zeros(cap, np.uint8)
        written = self._lib.cgic_huff_encode(
            np.ascontiguousarray(symbols, np.int32), n,
            np.ascontiguousarray(lens, np.uint16),
            np.ascontiguousarray(code_bytes.reshape(-1), np.uint8),
            np.int32(lens.shape[0]), out, cap)
        if written < 0:
            return None
        return out[:written].tobytes()

    def huff_build_lut(self, trie: np.ndarray) -> np.ndarray:
        """The 12-bit decode LUT of a fixed code table, built once and
        passed back to huff_decode."""
        lut = np.empty(int(self._lib.cgic_huff_lut_size()), np.int32)
        self._lib.cgic_huff_build_lut(
            np.ascontiguousarray(trie, np.int32),
            np.int32(trie.size // 2), lut)
        return lut

    def huff_decode(self, data: bytes, trie: np.ndarray,
                    lut: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
        buf = np.frombuffer(data, np.uint8)
        cap = max(1, len(data) * 8)    # payload bits bound the symbols
        out = np.empty(cap, np.int32)  # the C++ writes exactly n entries
        n = self._lib.cgic_huff_decode(
            np.ascontiguousarray(buf), len(data),
            np.ascontiguousarray(trie, np.int32),
            np.int32(trie.size // 2),
            None if lut is None else lut.ctypes.data, out, cap)
        if n < 0:
            return None
        return out[:n]

    def bitmap_encode(self, bits: np.ndarray) -> Optional[bytes]:
        n = bits.size
        cap = 2 + (n + 7) // 8 + 8
        out = np.zeros(cap, np.uint8)
        written = self._lib.cgic_bitmap_encode(
            np.ascontiguousarray(bits, np.uint8), n, out, cap)
        if written < 0:
            return None
        return out[:written].tobytes()

    def bitmap_decode(self, data: bytes) -> Optional[np.ndarray]:
        buf = np.frombuffer(data, np.uint8)
        cap = max(1, len(data) * 8)
        out = np.zeros(cap, np.uint8)
        n = self._lib.cgic_bitmap_decode(np.ascontiguousarray(buf),
                                         len(data), out, cap)
        if n < 0:
            return None
        return out[:n]


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libentropy_codec_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    """g++ into a temporary name, then an atomic rename: processes that
    build at once never load a half-written library."""
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_native() -> Optional[NativeCodec]:
    """The native coder, built on first use; None when it cannot be built
    or loaded (the coders then take their pure-Python paths)."""
    global _NATIVE, _TRIED
    with _LOCK:
        if _TRIED:
            return _NATIVE
        _TRIED = True
        lib = library_path()
        if not os.path.exists(lib) and not _build(lib):
            return None
        try:
            _NATIVE = NativeCodec(ctypes.CDLL(lib))
        except OSError:
            _NATIVE = None
        return _NATIVE
