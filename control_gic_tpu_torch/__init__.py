"""control_gic_tpu_torch — the PyTorch and CUDA port of control_gic_tpu.

The JAX package beside it stays the reference: every module here mirrors the
module of the same name there, and the tests hold each against it. This
package imports torch and never jax, flax or control_gic_tpu.

Layout:
  ops/       numerics on tensors: entropy, router, VQ, resampling, norms,
             attention (plain versions and the CUDA kernel's wrapper)
  kernels/   hand-written CUDA sources and their nvcc build
  models/    nn.Modules in NCHW: blocks, encoder, decoder, the CGIC codec core
  coding/    Huffman and bitmap stream coders (byte-identical frames)
  codec.py   the sender/receiver round trip through stream files
  cli/       the inference CLI
  data/      the evaluation image dataset
  utils/     device selection, metrics, weights carried over from JAX or a
             reference checkpoint

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
