"""The model forward's share of the card's float32 peak while it runs:
each request's forward FLOPs (``work.forward_flops`` of the configuration's
reference) over its device time (CUDA events at the network's forward
boundary), summed over the window's requests, over 67 TFLOP/s. Layer:
model forward. Moves ``serve_p95_ms``."""

from perfbench import cells, work

UNIT = "%"


def read(rec: dict):
    if rec["mode"] != "serve":
        return None
    fwd = rec["device_ms"].get("forward", [])
    if not fwd or len(fwd) != len(rec["edges"]) - rec["failed"]:
        return None
    ref = cells.reference(rec)
    flops = sum(work.forward_flops(ref, rec["model"], rec["num_nodes"], e)
                for e in rec["edges"][:len(fwd)])
    return 100.0 * flops / (sum(fwd) / 1e3) / work.F32_PEAK_FLOPS
