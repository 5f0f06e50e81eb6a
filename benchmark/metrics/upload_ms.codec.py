"""The host's uploads: the seconds of the `cgic.codec.upload` spans of the
traced window (CGICCodec._upload: staging in pinned memory and the copy
enqueued), ms per image of the window's roots (`cgic.codec.roundtrip`,
`cgic.tiling.compress`). None where the program keeps no spans or kept
none."""

ROOTS = ("cgic.codec.roundtrip", "cgic.tiling.compress")


def read(d):
    try:
        from control_gic_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.spans()
    images = sum(s.attrs.get("images", 0) for s in spans if s.name in ROOTS)
    if not images:
        return None
    return 1e3 * sum(s.seconds for s in spans
                     if s.name == "cgic.codec.upload") / images
