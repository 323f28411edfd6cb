"""The share of the (destination slot, source slot, pixel) triples that
AttFuse's forward visits in the window (the counter
``fusion.attfuse_slots``, the robots' own pairs left out) that hold no
edge: 100 (1 - E sum P / visited), E each step's valid edges (the
record's ``edges``) and sum P the pixels of the fused scales. Layer:
fusion layer + kernels. Moves ``train_views_per_s``."""

from perfbench import program_spans

UNIT = "%"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "train" else None
    visited = w["counts"]["fusion.attfuse_slots"] if w is not None else 0
    if not visited:
        return None
    H, W = rec["model"]["image_size"]
    pixels = sum((H >> (i + 1)) * (W >> (i + 1))
                 for i in range(len(rec["model"]["encoder_channels"])))
    return 100.0 * (1.0 - sum(rec["edges"]) * pixels / visited)
