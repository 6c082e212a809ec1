"""Model operations of a train step (``work.train_flops_model``: 3 x the
forward products) over the traced steps' host-clock wall a step, as a
share of the card's bf16 peak."""

UNIT = "%"
LAYER = "model step (models/gpt2.py, models/mmtg.py)"
MOVES = "train_samples_s"


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"] or t["window_s"] <= 0:
        return None
    w = record.work
    return 100.0 * w["flops"] * w["steps"] / t["window_s"] / w["bf16_peak"]
