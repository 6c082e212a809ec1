"""The decode-attention kernel (``ops/decode_attention.py`` →
``csrc/decode_attention.cu``) as a share of its roofline: the least time for
the live int8 cache rows and scales read, q and the key mask read, the
appends written and the context written, over every layer and step of the
traced call (``work.decode_attention_least``), over the kernel's device
time."""

import re

UNIT = "%"
LAYER = "kernels (ops/, csrc/)"
MOVES = "generate_tok_s"
KERNEL = re.compile(r"decode_attention\w*kernel", re.I)


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"]:
        return None
    busy = sum(s for n, s in t["self_s"].items() if KERNEL.search(n))
    if busy <= 0:
        return None
    return 100.0 * record.work["decode_attn_least_s"] / busy
