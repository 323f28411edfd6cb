"""The program's own spans and counters, for the per-layer metrics that
read them (``mrp_gnn_tpu_torch.utils.profiling``: its docstring names every
span and counter).

``run.py`` loads ``metrics/*.py`` only under ``--trace 1``, and before any
set-up. The readers of the program's spans import this module, so
importing it turns the program's recorder on, and an untraced run never
does. In a checkout whose program has no recorder it stays off, and the
readers read nothing.

At read time the window is taken from the consumer's own spans: the last
``record["steps"]`` ``train.step`` spans, or the last ``record["requests"]
- record["failed"]`` ``serve.request`` spans. A record of another name
belongs to the window when it starts between the first of those spans'
start and the last one's end. Nothing is read from a run without a
profile (a CPU run), as with the profiler's readers.
"""

from __future__ import annotations

from collections import defaultdict

try:
    from mrp_gnn_tpu_torch.utils import profiling as _program
except ImportError:
    _program = None
if _program is not None and hasattr(_program, "snapshot"):
    _program.enable()
else:
    _program = None

_CONSUMER = {"train": "train.step", "serve": "serve.request"}
_last: list = [None, None]   # (record, its snapshot): one sync a run


def _snapshot(record: dict) -> dict | None:
    if _program is None:
        return None
    if _last[0] is not record:
        _last[:] = [record, _program.snapshot()]
    return _last[1]


def window(record: dict) -> dict | None:
    """{"spans": {name: [span, ...]}, "counts": {name: total}} of the
    window, or None without a profile, a recorder or the window's spans."""
    if record.get("profile") is None:
        return None
    snap = _snapshot(record)
    if snap is None:
        return None
    name = _CONSUMER[record["mode"]]
    n = (record["steps"] if record["mode"] == "train"
         else record["requests"] - record["failed"])
    own = [s for s in snap["spans"] if s["name"] == name]
    if n <= 0 or len(own) < n:
        return None
    own = own[-n:]
    lo, hi = own[0]["start_ns"], own[-1]["end_ns"]
    spans: dict = defaultdict(list)
    spans[name] = own
    for s in snap["spans"]:
        if s["name"] != name and lo <= s["start_ns"] <= hi:
            spans[s["name"]].append(s)
    counts: dict = defaultdict(int)
    for c in snap["counts"]:
        if lo <= c["t_ns"] <= hi:
            counts[c["name"]] += c["n"]
    return {"spans": spans, "counts": counts}


def wall_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6
