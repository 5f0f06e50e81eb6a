"""The port imports torch and never JAX, flax or the JAX package."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "control_gic_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "control_gic_tpu")

MODULES = """
import control_gic_tpu_torch, control_gic_tpu_torch.codec
import control_gic_tpu_torch.pipeline
import control_gic_tpu_torch.cli.infer, control_gic_tpu_torch.utils.from_jax
import control_gic_tpu_torch.ops.norm_conv, control_gic_tpu_torch.ops.fused_norm
import control_gic_tpu_torch.kernels.build
import control_gic_tpu_torch.cli.train, control_gic_tpu_torch.cli.common
import control_gic_tpu_torch.config, control_gic_tpu_torch.train
import control_gic_tpu_torch.models.lpips
import control_gic_tpu_torch.models.discriminator
import control_gic_tpu_torch.utils.checkpoint, control_gic_tpu_torch.utils.logging
import control_gic_tpu_torch.utils.draw, control_gic_tpu_torch.data
import control_gic_tpu_torch.parallel, control_gic_tpu_torch.parallel.tiling
import control_gic_tpu_torch.parallel.mesh, control_gic_tpu_torch.parallel.multihost
import control_gic_tpu_torch.parallel.halo
import control_gic_tpu_torch.parallel.spatial_encoder
import control_gic_tpu_torch.parallel.spatial_decoder
import control_gic_tpu_torch.parallel.spatial_codec
import control_gic_tpu_torch.cli.infer_highres
import control_gic_tpu_torch.coding.native_lib
import control_gic_tpu_torch.coding.huffman_device
import control_gic_tpu_torch.coding.stream_pack
import control_gic_tpu_torch.coding.huffman_decode_device
import control_gic_tpu_torch.utils.programs, control_gic_tpu_torch.utils.metrics
import control_gic_tpu_torch.utils.trace
import chip_smoke
"""
CHECK = """
import sys
{modules}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
assert not bad, bad
assert "torch" in sys.modules
print("ok")
"""


def _run(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_import_pulls_in_no_jax():
    _run(CHECK.format(modules=MODULES, forbidden=set(FORBIDDEN)))


def test_import_pulls_in_no_optional_package():
    """PIL, PyYAML and wandb are imported where they are needed (reading an
    image, a config, logging to wandb), never by importing a module: the
    card's machine need not have them."""
    _run(CHECK.format(modules=MODULES, forbidden={"PIL", "yaml", "wandb"}))


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


def test_every_kernel_source_is_built_and_driven():
    """Each CUDA source of kernels/ has its exported functions declared in
    kernels/build.SIGNATURES, and chip_smoke.py builds it and holds a kernel
    of it against its plain version (chip_smoke.KERNELS)."""
    import chip_smoke
    from control_gic_tpu_torch.kernels import build
    sources = {f[:-3] for f in os.listdir(build.KERNEL_DIR)
               if f.endswith(".cu")}
    assert sources == set(build.SIGNATURES)
    assert sources == {os.path.basename(k["source"])[:-3]
                       for k in chip_smoke.KERNELS.values()}
    assert "huffman_scan" in sources
