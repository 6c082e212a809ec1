"""The traced ``generate`` call's operations (encoder, projector, prefill,
every step's products and decode attention; ``work.generate_flops``) over
its host-clock wall, as a share of the card's bf16 peak."""

UNIT = "%"
LAYER = "model step (models/gpt2.py, models/mmtg.py)"
MOVES = "generate_tok_s"


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"] or t["window_s"] <= 0:
        return None
    w = record.work
    return 100.0 * w["flops"] / t["window_s"] / w["bf16_peak"]
