"""Multi-channel experience encoder (:mod:`mmtg_tpu.models.encoder`).

Topic channel: Linear 2048→512 on the topic WenLan embedding. Image / text
channels: GRU stacks 2048→512 over the 5 experience steps — the hand-written
fused GRU kernel (:func:`mmtg_tpu_torch.ops.fused_gru.fused_gru`) when
``use_fused_gru`` and the channel is a single-layer GRU, the GRU scan
otherwise (always in training, as in the JAX package). The TRM / LSTM / RNN channels are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mmtg_tpu_torch.configs import ModelConfig
from mmtg_tpu_torch.ops.fused_gru import fused_gru
from mmtg_tpu_torch.ops.rnn import rnn_forward


def encoder_forward(
    params: Dict,
    cfg: ModelConfig,
    topic: torch.Tensor,
    image: torch.Tensor,
    text: torch.Tensor,
    use_fused_gru: bool = False,
    dropout_gen: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``topic`` ``[B, in]``; ``image`` / ``text`` ``[T, B, in]``.
    Returns (topic ``[1, B, H]``, image ``[T, B, H]``, text ``[T, B, H]``).
    ``dropout_gen`` (train only; it draws the masks' seeds) turns
    on the GRU stacks' inter-layer dropout at ``cfg.dropout``; the fused
    GRU kernel has no gradient and is for inference."""
    out_topic = (topic @ params["topic_fc"]["w"] + params["topic_fc"]["b"])[None]
    outs = {}
    for name, x, ch in (("image", image, cfg.image), ("text", text, cfg.text)):
        if ch.type != "GRU":
            raise NotImplementedError(
                f"encoder channel type {ch.type!r}: only GRU is ported")
        if use_fused_gru and ch.num_layers == 1:
            lp = params[name]["layers"][0]
            outs[name] = fused_gru(x, lp["w_ih"], lp["w_hh"], lp["b_ih"],
                                   lp["b_hh"])
        else:
            outs[name], _ = rnn_forward(params[name], x, ch.type,
                                        dropout_rate=cfg.dropout,
                                        dropout_gen=dropout_gen)
    return out_topic, outs["image"], outs["text"]
