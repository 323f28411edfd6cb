"""AttFuse's forward kernel against its roofline: the forward share of
the reference's ``fusion_work`` (4 E sum P C operations; the maps read
and written once) at ``work.least_seconds``, summed over the window's
steps, over the device milliseconds of the window's ``fusion.attfuse``
spans (CUDA events around each launch of the forward kernel, one a
fused scale). Layer: fusion layer + kernels. Moves
``train_views_per_s``."""

from perfbench import cells, program_spans, work

UNIT = "%"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "train" else None
    spans = w["spans"]["fusion.attfuse"] if w is not None else []
    ms = [s["device_ms"] for s in spans]
    if not ms or None in ms:
        return None
    ref = cells.reference(rec)
    least = sum(work.least_seconds(*ref.fusion_work(
        rec["model"], rec["num_nodes"], e, backward=False))
        for e in rec["edges"])
    return work.share_pct(least, sum(ms) / 1e3)
