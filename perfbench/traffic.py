"""Open-loop arrivals and the latency arithmetic over them.

Arrivals come at ``rate`` per second over ``seconds``, round(rate x
seconds) requests, in one of two kinds (a traffic file's ``arrivals``):

- ``periodic``: one every 1 / rate seconds, as a camera triggers its
  frames;
- ``poisson``: gaps that are the quantiles (k + 1/2) / n of the
  exponential distribution, in an order that the seed shuffles, so that
  two seeds differ in the order of bursts and lulls, not in how many
  requests arrive or how long they span.

A request is timed from its due time, not from when the server took it
up, so a stall counts against every request queued behind it; a failed
request counts as missing every limit (its latency is infinite).
"""

from __future__ import annotations

import math

import numpy as np


ARRIVALS = ("periodic", "poisson")


def due_times(rate: float, seconds: float, seed: int,
              arrivals: str) -> np.ndarray:
    """Seconds from the window's start at which each request is due; the
    first is due at 0."""
    if arrivals not in ARRIVALS:
        raise ValueError(f"unknown arrivals {arrivals!r}; one of {ARRIVALS}")
    n = max(int(round(rate * seconds)), 1)
    if arrivals == "periodic":
        return np.arange(n) / rate
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng(seed).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def latency_ms(due_s, done_s) -> np.ndarray:
    """Milliseconds from each request's due time to its outputs on the
    host; ``done_s`` None (or NaN) marks a failed request."""
    done = np.array([math.nan if d is None else d for d in done_s], float)
    lat = (done - np.asarray(due_s, float)) * 1e3
    lat[np.isnan(lat)] = math.inf
    return lat


def percentile(lat_ms: np.ndarray, q: float) -> float:
    """The q-th percentile (linear between order statistics); infinite
    when it falls among the failed requests."""
    lat = np.sort(np.asarray(lat_ms, float))
    pos = (len(lat) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(lat[hi]):
        return math.inf
    return float(lat[lo] + (lat[hi] - lat[lo]) * (pos - lo))


def lateness_growth_ms(due_s, start_s) -> float:
    """How much later the server took requests up in the window's last
    third than in its first (mean over each third): near 0 below capacity,
    growing with the window above it."""
    late = (np.asarray(start_s, float) - np.asarray(due_s, float)) * 1e3
    third = max(len(late) // 3, 1)
    return float(late[-third:].mean() - late[:third].mean())
