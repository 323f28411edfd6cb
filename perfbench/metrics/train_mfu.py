"""The training window's share of the card's float32 peak: every step's
FLOPs (``work.step_flops`` of the configuration's reference at the step's
valid edge count), over the window's seconds, over 67 TFLOP/s. Layer:
train step. Moves ``train_views_per_s``."""

from perfbench import cells, work

UNIT = "%"


def read(rec: dict):
    if rec["mode"] != "train" or not rec["edges"]:
        return None
    ref = cells.reference(rec)
    flops = sum(work.step_flops(ref, rec["model"], rec["num_nodes"], e)
                for e in rec["edges"])
    return 100.0 * flops / rec["window_s"] / work.F32_PEAK_FLOPS
