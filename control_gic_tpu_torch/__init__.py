"""control_gic_tpu_torch — the PyTorch and CUDA port of control_gic_tpu.

The JAX package beside it stays the reference: every module here mirrors the
module of the same name there, and the tests hold each against it. This
package imports torch and never jax, flax or control_gic_tpu.

Layout:
  ops/       numerics on tensors: entropy, router, VQ, resampling, norms,
             attention and its gradient (plain versions, the CUDA kernels'
             wrappers and their autograd Functions)
  kernels/   hand-written CUDA sources and their nvcc build
  models/    nn.Modules in NCHW: blocks, encoder, decoder, the CGIC codec
             core, LPIPS and the PatchGAN discriminator
  coding/    Huffman and bitmap stream coders (byte-identical frames)
  codec.py   the sender/receiver round trip through stream files
  train/     losses, the train state and the fused generator +
             discriminator step
  config.py  YAML run configs
  cli/       the inference and training CLIs
  data/      the training and evaluation image datasets, the prefetcher
  utils/     device selection, metrics, checkpoints, logging, partition-map
             drawing, weights carried over from JAX or a reference checkpoint

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
