"""The port imports torch and never JAX, flax or the JAX package."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "control_gic_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "control_gic_tpu")

CHECK = """
import sys
import control_gic_tpu_torch, control_gic_tpu_torch.codec
import control_gic_tpu_torch.cli.infer, control_gic_tpu_torch.utils.from_jax
import control_gic_tpu_torch.ops.norm_conv, control_gic_tpu_torch.ops.fused_norm
import control_gic_tpu_torch.kernels.build
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
assert not bad, bad
assert "torch" in sys.modules
print("ok")
"""


def test_import_pulls_in_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", CHECK.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
