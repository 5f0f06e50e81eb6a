"""Multi-tile codecs (port of control_gic_tpu/parallel/): the high-res tiled
codec, `tiling.compress_tiled`."""
