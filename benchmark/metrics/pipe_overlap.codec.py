"""How far the codec's host stages overlap each other and the device: the
stages' seconds summed (last_pipeline_stats of roundtrip_pipelined or
compress_tiled_device: upload, syncs, fetches, framing, rebuild, decode
dispatch) over the calls' wall seconds, over the window's calls."""


def read(d):
    calls = d.get("pipeline")
    if not calls:
        return None
    stages = sum(v for s in calls for k, v in s.items()
                 if k.endswith("_s") and k != "wall_s")
    wall = sum(s["wall_s"] for s in calls)
    return stages / wall if wall > 0 else None
