"""Finds a serving cell's knee: the highest rate at which, on every seed,
the 95th percentile stays within the latency limit over a window of the
cell's length, no request fails and the server's lateness does not grow
through the window.

    python3 -m perfbench.knee --workload dense_serve --seeds 7,8,9 \
        [--seconds 50] [--fractions 0.6,0.7,...] [--arrivals periodic] \
        [--out FILE]

One process: set-up once a seed, then a closed loop of back-to-back
requests for the service time (its inverse is the capacity), then, at each
fraction of the capacity from the lowest, one window of ``--seconds`` a
seed. The sweep stops at the first fraction that fails on any seed; the
knee is the fraction below it. One JSON line a window; the last line names
the knee and 4/5 of it, the rate that the cell's traffic file holds.
``--arrivals`` sweeps another kind of arrivals than the traffic file's.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from perfbench import calibrate, cells, traffic
from perfbench.drivers.serve import ServeCell

CLOSED_LOOP_REQUESTS = 100
STEADY_GROWTH_MS = 5.0  # lateness growth below this counts as steady
MAX_RATE = 150.0        # requests a second; above any cell's capacity


def sustained(line: dict, limit_ms: float) -> bool:
    """Whether a window held: p95 within the limit, nothing failed, and
    the lateness steady."""
    return (line["p95_ms"] <= limit_ms and line["failed"] == 0
            and line["lateness_growth_ms"] < STEADY_GROWTH_MS)


def sweep(fractions, seeds, window, limit_ms: float, emit) -> float | None:
    """Runs ``window(fraction, seed) -> line`` at each fraction from the
    lowest, for every seed, until a window fails; returns the highest
    fraction that held on every seed (None if the first failed)."""
    knee = None
    for f in sorted(fractions):
        for seed in seeds:
            line = window(f, seed)
            line["sustained"] = sustained(line, limit_ms)
            emit(line)
            if not line["sustained"]:
                return knee
        knee = f
    return knee


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="7,8,9", help="e.g. 7-9 or 3,5")
    p.add_argument("--seconds", type=float, default=50.0)
    p.add_argument("--fractions",
                   default="0.5,0.6,0.7,0.75,0.8,0.85,0.9,0.95,1.0")
    p.add_argument("--arrivals", choices=traffic.ARRIVALS, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from perfbench.run import require_cards
    cell = cells.cell(args.workload)
    device = require_cards(cell["chips"])
    limit = cell["traffic_doc"]["latency_limit_ms"]
    arrivals = args.arrivals or cell["traffic_doc"]["arrivals"]
    seeds = calibrate.seed_range(args.seeds)

    def emit(line: dict) -> None:
        text = json.dumps({"workload": args.workload, "arrivals": arrivals,
                           **line})
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    # inputs for the fastest window: capacity is below MAX_RATE
    made = {s: ServeCell(cell, s, device, rate=1.0, seconds=1.0,
                         requests=int(MAX_RATE * args.seconds),
                         arrivals=arrivals)
            for s in seeds}
    c = made[seeds[0]]
    c.due = np.zeros(CLOSED_LOOP_REQUESTS)
    w = c.window()
    service_ms = w["window_s"] * 1e3 / CLOSED_LOOP_REQUESTS
    capacity = 1e3 / service_ms
    emit({"closed_loop_service_ms": service_ms, "capacity_per_s": capacity})

    def window(f: float, seed: int) -> dict:
        c = made[seed]
        rate = f * capacity
        c.due = traffic.due_times(rate, args.seconds, seed, arrivals)
        w = c.window()
        lat = w["latency_ms"]
        return {"fraction": f, "seed": seed, "rate_per_s": rate,
                "requests": w["requests"], "failed": w["failed"],
                "p50_ms": traffic.percentile(lat, 50),
                "p95_ms": traffic.percentile(lat, 95),
                "p99_ms": traffic.percentile(lat, 99),
                "over_limit_pct": 100.0 * float(np.mean(lat > limit)),
                "lateness_growth_ms": w["lateness_growth_ms"]}

    fractions = [float(f) for f in args.fractions.split(",")]
    knee = sweep(fractions, seeds, window, limit, emit)
    rate = None if knee is None else knee * capacity
    emit({"knee_fraction": knee, "knee_per_s": rate,
          "cell_rate_per_s": None if rate is None else 0.8 * rate,
          "latency_limit_ms": limit})
    return 0


if __name__ == "__main__":
    sys.exit(main())
