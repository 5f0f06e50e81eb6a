"""The collectives' share of their roofline: the ring's bound time of the
bytes the port's counters give for the traced window
(`common/collectives.py`: all-reduce 2 (n - 1) / n S, all-gather
(n - 1) / n S_out, over the card's link in one direction) over the device
time of the NCCL kernels, in %. None on a port that counts no collectives
(`parallel.multihost.COLLECTIVE_BYTES`) or where no NCCL kernel ran."""
from common import collectives
from common.trace import seconds_matching

PATTERN = "nccl"


def read(d):
    sent, ranks, link = (d.get("collective_bytes"), d.get("ranks"),
                         d.get("link_bytes_s"))
    spent = seconds_matching(d.get("device_ops", {}), PATTERN)
    if not sent or not ranks or not link or spent <= 0:
        return None
    return 100.0 * collectives.bound_s(sent, ranks, link) / spent
