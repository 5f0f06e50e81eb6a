"""The flash backward kernels' share of their roofline: the bound time of
every attention's backward (10 B Tq Tk C operations at the dtype's peak,
or eight tensors once over the memory rate) over the device time of the
kernels named flash_bwd_* (the delta pre-pass, dk/dv and dq), in %."""
from common import flops
from common.readers import roofline

PATTERN = "flash_bwd_"


def read(d):
    return roofline(d, "flash_bwd", PATTERN, flops.flash_bwd_bound_s)
