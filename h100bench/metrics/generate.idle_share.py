"""The share of the traced ``generate`` call's host-clock wall in which no
operation ran on the card: 1 - the union of its device intervals over the
wall."""

UNIT = "%"
LAYER = "device"
MOVES = "generate_tok_s"


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"] or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
