"""The host's own part of a single-image request: the self time of each
`cgic.codec.compress` span of the traced window, ms, mean over the
window's requests. Self time is the span's seconds less the spans under it
in which the device holds the host: its device waits, queue waits and
program replays (a replay enqueues a captured program; its launch blocks
while the device's queue is full, so its time is mostly the device's).
What is left is the host's work: the upload, the program key, the entropy
coding, the stream files and the rebuild. None where the program keeps no
spans (control_gic_tpu_torch.utils.trace) or kept none."""

WAITS = ("cgic.codec.device_wait", "cgic.pipe.queue_wait",
         "cgic.programs.replay")


def read(d):
    try:
        from control_gic_tpu_torch.utils import trace
    except ImportError:
        return None
    own = [t for _, t in trace.self_seconds(trace.spans(),
                                            "cgic.codec.compress", WAITS)]
    return 1e3 * sum(own) / len(own) if own else None
