"""Host milliseconds a training step waits for its next placed batch
(``next()`` on the loop's stream), mean over the window's steps. Layer:
training loop + data. Moves ``train_views_per_s``."""

import statistics

UNIT = "ms"


def read(rec: dict):
    waits = rec["spans_ms"].get("data_wait") if rec["mode"] == "train" else None
    return statistics.fmean(waits) if waits else None
