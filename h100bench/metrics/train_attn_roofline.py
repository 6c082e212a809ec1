"""The train-attention kernels (``ops/train_attention.py`` →
``csrc/train_attention.cu``, forward and backward) as a share of their
roofline: the least time of the 12 layers' causal attention forward and
backward a step (``work.train_attention_least``), over the kernels' device
time."""

import re

UNIT = "%"
LAYER = "kernels (ops/, csrc/)"
MOVES = "train_samples_s"
KERNEL = re.compile(r"mha_\w*kernel", re.I)


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"]:
        return None
    busy = sum(s for n, s in t["self_s"].items() if KERNEL.search(n))
    if busy <= 0:
        return None
    return 100.0 * record.work["attn_least_s"] * record.work["steps"] / busy
