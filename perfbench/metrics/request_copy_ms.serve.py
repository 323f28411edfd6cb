"""Host milliseconds a request spends copying: the program's
``serve.copy_in`` (frames to the card from pageable memory) and
``serve.copy_out`` (outputs back, the forward already waited for) spans of
``Predictor.__call__``, mean over the window's requests. Layer: serving
request path. Moves ``serve_p95_ms``."""

from perfbench import program_spans

UNIT = "ms"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "serve" else None
    if w is None:
        return None
    n = len(w["spans"]["serve.request"])
    ins, outs = w["spans"]["serve.copy_in"], w["spans"]["serve.copy_out"]
    if len(ins) != n or len(outs) != n:
        return None
    return sum(map(program_spans.wall_ms, ins + outs)) / n
