"""The fusion layer's least forward time (the ``fusion_work`` of the
configuration's reference, at ``work.least_seconds``) over its device time
(CUDA events at ``GraphFusionLayer``'s forward boundary), summed over the
window's requests. Layer: fusion + kernels. Moves ``serve_p95_ms``."""

from perfbench import cells, work

UNIT = "%"


def read(rec: dict):
    if rec["mode"] != "serve":
        return None
    fwd = rec["device_ms"].get("fusion", [])
    if not fwd or len(fwd) != len(rec["edges"]) - rec["failed"]:
        return None
    ref = cells.reference(rec)
    least = sum(work.least_seconds(*ref.fusion_work(
        rec["model"], rec["num_nodes"], e, backward=False))
        for e in rec["edges"][:len(fwd)])
    return work.share_pct(least, sum(fwd) / 1e3)
