"""AttFuse's backward kernels against their roofline: the backward share
of the reference's ``fusion_work`` (twice the forward's operations; the
maps and their gradients read once, the input gradients written once) at
``work.least_seconds``, summed over the window's steps, over the device
milliseconds of the window's ``fusion.attfuse_backward`` spans (CUDA
events around the backward's launches, one span a fused scale). Layer:
fusion layer + kernels. Moves ``train_views_per_s``."""

from perfbench import cells, program_spans, work

UNIT = "%"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "train" else None
    spans = w["spans"]["fusion.attfuse_backward"] if w is not None else []
    ms = [s["device_ms"] for s in spans]
    if not ms or None in ms:
        return None
    ref = cells.reference(rec)
    least = 0.0
    for e in rec["edges"]:
        f1, b1 = ref.fusion_work(rec["model"], rec["num_nodes"], e, False)
        f3, b3 = ref.fusion_work(rec["model"], rec["num_nodes"], e, True)
        least += work.least_seconds(f3 - f1, b3 - b1)
    return work.share_pct(least, sum(ms) / 1e3)
