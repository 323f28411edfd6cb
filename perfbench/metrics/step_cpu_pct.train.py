"""The launching thread's CPU time over its wall time in the program's
``train.step`` spans, summed over the window's steps: under 100% the
thread waited, for the interpreter lock, a core or a blocked call. Layer:
train step / model forward. Moves ``train_views_per_s``."""

from perfbench import program_spans

UNIT = "%"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "train" else None
    if w is None:
        return None
    steps = w["spans"]["train.step"]
    wall = sum(s["end_ns"] - s["start_ns"] for s in steps)
    return 100.0 * sum(s["cpu_ns"] for s in steps) / wall if wall else None
