"""Host milliseconds the training thread spends in a step of the program
(its ``train.step`` span: forward, backward and update enqueued, no
sync), mean over the window's steps. Layer: train step / model forward.
Moves ``train_views_per_s``."""

import statistics

from perfbench import program_spans

UNIT = "ms"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "train" else None
    if w is None:
        return None
    return statistics.fmean(map(program_spans.wall_ms,
                                w["spans"]["train.step"]))
