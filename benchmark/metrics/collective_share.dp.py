"""The process group's share of card 0's busy time in the traced window:
the device time of the NCCL kernels (their names hold `nccl`), waits for
the other ranks inside them included, over the union of the device's
operation intervals, in %. None on a port that counts no collectives
(`parallel.multihost.COLLECTIVE_BYTES`) or where no NCCL kernel ran."""
from common.trace import seconds_matching

PATTERN = "nccl"


def read(d):
    spent = seconds_matching(d.get("device_ops", {}), PATTERN)
    if not d.get("collective_bytes") or not d.get("busy_s") or spent <= 0:
        return None
    return 100.0 * spent / d["busy_s"]
