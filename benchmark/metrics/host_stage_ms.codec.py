"""The host work of the codec's busiest pipeline stage: the largest, over
stages a, b and c, of the stage's self time summed over the traced window,
ms per image of the window's roots (`cgic.codec.roundtrip`,
`cgic.tiling.compress`). Self time is a `cgic.pipe.<stage>` span's seconds
less the spans under it in which the device holds the host: its device
waits, queue waits and program replays (a replay's launch blocks while the
device's queue is full). Against the device's time an image, it says how
close the host comes to setting the pace. None where the program keeps no
spans or kept none."""

ROOTS = ("cgic.codec.roundtrip", "cgic.tiling.compress")
WAITS = ("cgic.codec.device_wait", "cgic.pipe.queue_wait",
         "cgic.programs.replay")


def read(d):
    try:
        from control_gic_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.spans()
    images = sum(s.attrs.get("images", 0) for s in spans if s.name in ROOTS)
    if not images:
        return None
    busiest = max(sum(t for _, t in trace.self_seconds(
        spans, f"cgic.pipe.{x}", WAITS)) for x in "abc")
    return 1e3 * busiest / images
