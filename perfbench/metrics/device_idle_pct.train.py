"""The share of a steady profiler window of training steps in which no
kernel, copy or set ran on the card (the warm-up trace thrown away).
Layer: device. Moves ``train_views_per_s``."""

UNIT = "%"


def read(rec: dict):
    p = rec["profile"]
    if rec["mode"] != "train" or not p:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
