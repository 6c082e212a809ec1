"""Kernel launches a decode step: the device kernels of the traced
``generate`` call (encoder and prefill included) over its steps. The host
pays a launch for each, so on the per-layer path it sets how far the host
holds the card back."""

UNIT = "count"
LAYER = "decoding.py host loop"
MOVES = "generate_tok_s"


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"] or not t["kernels"]:
        return None
    return t["kernels"] / record.work["steps"]
