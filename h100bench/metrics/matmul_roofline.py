"""The dense products of the traced ``generate`` call (``ops/matmul.py`` →
``csrc/matmul.cu``, or any library product) as a share of their roofline:
the summed least time of every product the per-layer path runs, from its
operations and bytes (``work.generate_products``), over the device time of
the dense-product kernels."""

import re

UNIT = "%"
LAYER = "kernels (ops/, csrc/)"
MOVES = "generate_tok_s"
KERNEL = re.compile(r"matmul_(?:bf16|f32|small)_kernel|nvjet|xmma|cutlass|gemm|"
                    r"gemv|cublas|splitkreduce", re.I)


def read(record):
    t = record.trace
    if t is None or not t["on_gpu"]:
        return None
    busy = sum(s for n, s in t["self_s"].items() if KERNEL.search(n))
    if busy <= 0:
        return None
    return 100.0 * record.work["matmul_least_s"] / busy
