"""The training step's operations (benchmark/common/flops.py:
generator 3F, LPIPS 3F, discriminator 8F) in the window, over the window
and the card's f32 peak outside the tensor cores (TF32 is off), in %."""
from common.readers import mfu


def read(d):
    return mfu(d, "float32")
