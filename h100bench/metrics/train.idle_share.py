"""The share of the traced steps' host-clock wall in which no operation
ran on the card."""

UNIT = "%"
LAYER = "device"
MOVES = "train_samples_s"


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"] or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
