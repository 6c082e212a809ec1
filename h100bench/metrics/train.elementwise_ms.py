"""Device milliseconds a step in the trace's ``elementwise fusion``
category (the train step's eager pointwise kernels)."""

UNIT = "ms"
LAYER = "train step (train.py, models/gpt2.py)"
MOVES = "train_samples_s"
CATEGORY = "elementwise fusion"


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"]:
        return None
    ms = 1e3 * t["categories_s"].get(CATEGORY, 0.0) / record.work["steps"]
    return ms if ms > 0 else None
