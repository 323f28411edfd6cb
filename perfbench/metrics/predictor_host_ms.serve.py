"""Per request, the host wall time of making the Predictor and of its call,
less the model forward's device time (CUDA events at the network's
forward boundary): the copies, the synchronisation and the Python around
them; mean over the window's requests. Layer: serving request path.
Moves ``serve_p95_ms``."""

import statistics

UNIT = "ms"


def read(rec: dict):
    if rec["mode"] != "serve":
        return None
    host = rec["spans_ms"].get("predictor")
    fwd = rec["device_ms"].get("forward")
    if not host or not fwd or len(host) != len(fwd):
        return None
    return statistics.fmean(host) - statistics.fmean(fwd)
