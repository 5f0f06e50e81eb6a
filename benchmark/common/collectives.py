"""The least time a collective can take, and the cards' links.

A ring all-reduce of S bytes over n ranks sends and receives
2 (n - 1) / n S bytes on each rank's link (a reduce-scatter, then an
all-gather, each of (n - 1) / n S); a ring all-gather whose result is S_out
bytes, (n - 1) / n S_out. The bound time is those bytes over the link's rate
in one direction. The ops are keyed as the port counts them
(`parallel.multihost.COLLECTIVE_BYTES`: the bytes of each result on this
rank).

The ring's count is the algorithm NCCL chooses for the training step: on
four H100 SXM cards behind NVSwitch, NCCL 2.28.9's tuning log gives RING
for every one of its collectives (the 521,435,868-byte gradient mean with
the SIMPLE protocol, 2,653,444 bytes with LL128, the small ones with LL),
although NVLink SHARP (NVLS) is available there. The kernels' names are not
read for it: they name the kernel's specialisation
(`ncclDevKernel_AllReduce_Sum_f32_RING_LL` ran the SIMPLE transfer too).

Link rates, one direction, from NVIDIA's data sheets: the SXM part's
NVLink 4 (18 links, 900 GB/s both ways), the NVL part's bridge (600 GB/s
both ways), and PCIe Gen5 x16 (128 GB/s both ways).
"""
from __future__ import annotations

from typing import Dict, Optional

LINK_BYTES_S = {"PCIe": 64e9, "NVL": 300e9, "SXM": 450e9}

RING = {"all_reduce": lambda n: 2.0 * (n - 1) / n,
        "all_gather": lambda n: (n - 1) / n}


def link_bytes_s(card: Optional[str]) -> Optional[float]:
    """One direction of a card's link to its peers, bytes/s (None without
    a card)."""
    if not card:
        return None
    for key in ("PCIe", "NVL"):
        if key in card:
            return LINK_BYTES_S[key]
    return LINK_BYTES_S["SXM"]


def bound_s(bytes_by_op: Dict[str, float], ranks: int,
            link: float) -> float:
    """The ring's bound time of the collectives whose result bytes
    `bytes_by_op` gives, over `ranks` ranks and a link of `link` bytes/s."""
    return sum(RING[op](ranks) * b for op, b in bytes_by_op.items()) / link
