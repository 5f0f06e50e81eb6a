"""The codec's model operations (benchmark/common/flops.py, from the
configuration and the image size) in the window, over the window and the
card's bf16 dense peak, in %."""
from common.readers import mfu


def read(d):
    return mfu(d, "bfloat16")
