"""Device milliseconds a served request keeps the card busy: the union of
every kernel, copy and set in a steady profiler window of requests (the
warm-up trace thrown away), over the requests in it. At a fixed arrival
rate any work taken off the card lowers it, and work moved onto the host
does not. Layer: device. Moves ``serve_p95_ms``."""

UNIT = "ms"


def read(rec: dict):
    p = rec["profile"]
    if rec["mode"] != "serve" or not p or not p.get("calls"):
        return None
    return 1e3 * p["busy_s"] / p["calls"]
