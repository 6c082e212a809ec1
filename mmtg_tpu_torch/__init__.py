"""mmtg_tpu_torch — the PyTorch / CUDA port of :mod:`mmtg_tpu`.

The JAX package ``mmtg_tpu`` stays the reference. This package mirrors its
layout (``models/``, ``ops/``, ``decoding``, ``checkpoint``, ``generate``)
and keeps its parameter layout: stacked ``[L, ...]`` GPT-2 layers and
``x @ W`` weights, so parameters move between the two as plain arrays
(:mod:`mmtg_tpu_torch.params`).

It imports ``torch`` and never ``jax``; the JAX-free modules of the old
package (``mmtg_tpu.configs``, ``.tokenizer``, ``.bpe``, ``.data``) are
shared rather than copied. Each TPU kernel on the decode path has a
hand-written CUDA kernel for Hopper under ``csrc/`` beside its plain
PyTorch version; a wrapper launches the kernel for CUDA tensors and uses the
plain version for CPU tensors.
"""
