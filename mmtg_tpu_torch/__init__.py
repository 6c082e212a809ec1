"""mmtg_tpu_torch — the PyTorch / CUDA port of :mod:`mmtg_tpu`.

The JAX package ``mmtg_tpu`` stays the reference. This package mirrors its
layout (``models/``, ``ops/``, ``decoding``, ``loss``, ``train``,
``checkpoint``, ``generate``) and keeps its parameter layout: stacked
``[L, ...]`` GPT-2 layers and ``x @ W`` weights, so parameters and AdamW
moments move between the two as plain arrays (:mod:`mmtg_tpu_torch.params`).

It imports ``torch``, never ``jax``, and nothing of the JAX package: its
configs, tokenizers, dataset and logging helpers (``configs``,
``tokenizer``, ``bpe``, ``data``, ``utils.logging``) are its own copies of
the pure-Python paths. Each TPU kernel on the generation and train paths has
a hand-written CUDA kernel for Hopper under ``csrc/`` beside its plain
PyTorch version; a wrapper launches the kernel for CUDA tensors and uses the
plain version for CPU tensors. The CLIs run on the CUDA card unless
``--device cpu`` is given.
"""

from mmtg_tpu_torch.configs import (  # noqa: F401
    ChannelConfig,
    DataConfig,
    GenerateConfig,
    GPT2Config,
    ModelConfig,
    SpecialTokens,
    TrainConfig,
    english_variant,
)
