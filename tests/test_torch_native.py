"""The port's C++ entropy coder (coding/native_lib.py with its copy of
native/entropy_codec.cpp) against its pure-Python coders and the JAX
package's coders, byte for byte; and the shared state that the pipelined
codec's threads touch (launch counts, the weight-pack cache) under
threads."""
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from control_gic_tpu.coding import BitmapCodec as JBitmap
from control_gic_tpu.coding import HuffmanCodec as JHuffman
from control_gic_tpu_torch.coding import BitmapCodec, HuffmanCodec
from control_gic_tpu_torch.coding import native_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the coders take their pure-Python paths")
    lib = native_lib.get_native()
    assert lib is not None, "the C++ coder failed to build"
    return lib


def test_cpp_source_is_the_jax_packages():
    """Byte-identical to the JAX package's source but for one comment line,
    where the copy names the reference coder from its CGIC/ directory on,
    not by its path in the reference checkout."""
    with open(os.path.join(ROOT, "control_gic_tpu", "coding", "native",
                           "entropy_codec.cpp"), "rb") as f:
        theirs = f.read().splitlines(keepends=True)
    with open(native_lib._SRC, "rb") as f:
        ours = f.read().splitlines(keepends=True)
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert differ == [3]
    assert ours[3].startswith(b"// (CGIC/tools/indices_coding.py:91-126")
    assert theirs[3].endswith(ours[3][len(b"// ("):])


def test_library_builds_in_the_ports_build_dir(native):
    path = native_lib.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "control_gic_tpu_torch", "kernels", "_build")
    assert os.path.exists(path)
    assert HuffmanCodec({0: 1, 1: 2})._native is native
    assert BitmapCodec()._native is native


def _fib_table():
    """Fibonacci-skewed counts (the JAX package's test_coding tables): codes
    far past the 12-bit decode LUT and the 57-bit fast encode."""
    fib = [1, 1]
    for _ in range(198):
        fib.append(min(fib[-1] + fib[-2], 10 ** 17))
    return {i: int(f) for i, f in enumerate(fib)}


TABLES = {
    "uniform": lambda: {i: 5 for i in range(1024)},
    "zipf": lambda: {i: int(1e7 / (i + 1) ** 1.3) + 1 for i in range(1024)},
    "random": lambda: {i: int(c) for i, c in enumerate(
        np.random.default_rng(0).integers(0, 500, 1024))},
    "fib_longcodes": _fib_table,
    "zero_tail": lambda: dict(enumerate(
        np.r_[np.arange(1, 41), np.zeros(984, np.int64)].tolist())),
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_native_huffman_matches_python_and_jax(native, table):
    freqs = TABLES[table]()
    ours, theirs = HuffmanCodec(freqs), JHuffman(freqs)
    assert ours.codes == theirs.codes
    np.testing.assert_array_equal(ours.trie, theirs.trie)
    np.testing.assert_array_equal(ours.lens, theirs.lens)
    assert ours.code_stride == theirs.code_stride
    rng = np.random.default_rng(1)
    n_sym = len(freqs)
    # 20000 symbols pass the C++ decoder's LUT threshold (2^14 bits)
    for n in (1, 7, 300, 20000):
        syms = rng.integers(0, n_sym, size=n)
        data = ours.encode(syms)
        assert data == ours.encode_python(syms) == theirs.encode(syms)
        np.testing.assert_array_equal(ours.decode_array(data), syms)
        np.testing.assert_array_equal(ours.decode_python(data), syms)
        assert ours.decode_array(data).dtype == np.int32
    assert ours.encode([]) == b"" and ours.decode(b"") is None


@pytest.mark.parametrize("n", [1, 8, 13, 1024, 100_003])
def test_native_bitmap_matches_python_and_jax(native, n):
    bits = np.random.default_rng(n).integers(0, 2, size=n)
    data = BitmapCodec().encode(bits)
    assert data == BitmapCodec.encode_python(bits) == JBitmap().encode(bits)
    assert BitmapCodec().decode(data) == bits.tolist()
    assert BitmapCodec.decode_python(data) == bits.tolist()


def test_pure_python_fallback(monkeypatch):
    """Without the library (no compiler) the coders frame the same bytes."""
    freqs = TABLES["random"]()
    with_lib = HuffmanCodec(freqs)
    monkeypatch.setattr(native_lib, "_NATIVE", None)
    monkeypatch.setattr(native_lib, "_TRIED", True)
    without = HuffmanCodec(freqs)
    assert without._native is None and BitmapCodec()._native is None
    syms = np.random.default_rng(2).integers(0, 1024, size=999)
    data = without.encode(syms)
    assert data == with_lib.encode(syms)
    np.testing.assert_array_equal(without.decode_array(data), syms)
    bits = np.random.default_rng(3).integers(0, 2, size=77)
    assert BitmapCodec().decode(BitmapCodec().encode(bits)) == bits.tolist()
    with pytest.raises(ValueError, match="outside the table"):
        HuffmanCodec({0: 1}).decode_python(b"\x07\x80")


# ---------------------------------------- shared state under several threads

def _hammer(fn, threads=6, calls=2000):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [fn() for _ in
                                                    range(calls)])
                   for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    return threads * calls


def test_launch_counts_stay_exact_under_threads():
    from control_gic_tpu_torch.kernels import build
    counts = {"k": 0}
    n = _hammer(lambda: build.count_launch(counts, "k"))
    assert counts["k"] == n


def test_pack_cache_builds_once_under_threads():
    from control_gic_tpu_torch.ops import norm_conv
    w = torch.randn(8, 4)
    made = []

    def make():
        made.append(1)
        return w.t().contiguous()

    out = []
    _hammer(lambda: out.append(norm_conv._cached((w,), ("t",), make)),
            calls=200)
    assert len(made) == 1 and all(o is out[0] for o in out)
    w.add_(1.0)            # a new version builds anew, once
    norm_conv._cached((w,), ("t",), make)
    assert len(made) == 2
