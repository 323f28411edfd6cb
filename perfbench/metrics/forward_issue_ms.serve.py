"""Host milliseconds ``Predictor.__call__`` spends enqueueing the model
forward (the program's ``serve.forward`` span, no sync), mean over the
window's requests. Layer: serving request path. Moves
``serve_p95_ms``."""

import statistics

from perfbench import program_spans

UNIT = "ms"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "serve" else None
    if w is None or not w["spans"]["serve.forward"]:
        return None
    return statistics.fmean(map(program_spans.wall_ms,
                                w["spans"]["serve.forward"]))
