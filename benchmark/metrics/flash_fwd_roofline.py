"""The flash forward kernels' share of their roofline: the bound time of
every attention the kernels take (4 B Tq Tk C operations at the dtype's
peak, or q, k, v and o once over the memory rate), over the device time of
the kernels named flash_fwd_*, in %."""
from common import flops
from common.readers import roofline

PATTERN = "flash_fwd_"


def read(d):
    return roofline(d, "flash_fwd", PATTERN, flops.flash_fwd_bound_s)
