"""Seconds the program spent capturing its CUDA graphs in set-up (warm-up
runs included): Programs.capture_s of the cell's codec or Trainer."""


def read(d):
    return d.get("capture_s")
