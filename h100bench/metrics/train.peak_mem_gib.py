"""The card's peak allocated memory over the run up to the window's end
(``torch.cuda.max_memory_allocated``), in GiB."""

UNIT = "GiB"
LAYER = "memory"
MOVES = "train_samples_s"


def read(record):
    b = record.memory_peak_bytes
    return b / 2 ** 30 if b > 0 else None
