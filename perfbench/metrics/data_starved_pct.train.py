"""The share of the training loop's takes from the placed stream
(``data.take``, ``TransformIterator.__next__``) that found its queue
empty (the counter ``data.starved``), in the window. Layer: training loop
+ data. Moves ``train_views_per_s``."""

from perfbench import program_spans

UNIT = "%"


def read(rec: dict):
    w = program_spans.window(rec) if rec["mode"] == "train" else None
    if w is None or not w["spans"]["data.take"]:
        return None
    return 100.0 * w["counts"]["data.starved"] / len(w["spans"]["data.take"])
