"""Multi-channel experience encoder (:mod:`mmtg_tpu.models.encoder`).

Topic channel: Linear 2048→512 on the topic WenLan embedding. Image / text
channels, each of its ``ChannelConfig.type``:

  * GRU / LSTM / RNN stacks 2048→512 over the 5 experience steps
    (:func:`mmtg_tpu_torch.ops.rnn.rnn_forward`) — for a single-layer GRU
    with ``use_kernels`` the hand-written fused GRU kernel
    (:func:`mmtg_tpu_torch.ops.fused_gru.fused_gru`) instead, which has no
    gradient (never in training, as in the JAX package);
  * 'TRM': a small causal pre-LN transformer block over the steps
    (:func:`_trm_forward`). The reference mentions TRM but never implements
    it; the JAX package does, and the port follows the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mmtg_tpu_torch.configs import ModelConfig
from mmtg_tpu_torch.ops.fused_gru import fused_gru
from mmtg_tpu_torch.ops.matmul import matmul, matmul_plain
from mmtg_tpu_torch.ops.rnn import rnn_forward


def _trm_forward(p: Dict, x: torch.Tensor, n_head: int = 4) -> torch.Tensor:
    """``x`` ``[T, B, in]`` → ``[T, B, D]``: the input projection plus the
    first ``T`` rows of the position table, then one pre-LN block (LayerNorm
    eps 1e-5, ``n_head`` heads attending causally over the steps, masked
    scores set to -1e30, a tanh-approximated GELU MLP), as
    :func:`mmtg_tpu.models.encoder._trm_forward`."""
    T, B, _ = x.shape
    if T > p["pos"].shape[0]:
        raise ValueError(f"TRM channel: {T} steps, but its position table "
                         f"has {p['pos'].shape[0]} rows")
    h = x @ p["in_proj"]["w"] + p["in_proj"]["b"] + p["pos"][:T][:, None, :]
    h = h.transpose(0, 1)  # [B, T, D]
    D = h.shape[-1]
    hd = D // n_head

    def ln(v, g, b):
        mu = v.mean(dim=-1, keepdim=True)
        var = (v - mu).square().mean(dim=-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + 1e-5) * g + b

    a = ln(h, p["ln1_g"], p["ln1_b"])
    q, k, v = (a @ p["qkv_w"] + p["qkv_b"]).chunk(3, dim=-1)
    q, k, v = (t.reshape(B, T, n_head, hd).transpose(1, 2) for t in (q, k, v))
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, -1e30)
    ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, T, D)
    h = h + ctx @ p["proj_w"] + p["proj_b"]
    m = ln(h, p["ln2_g"], p["ln2_b"])
    # jax.nn.gelu's default is the tanh approximation
    h = h + F.gelu(m @ p["fc_w"] + p["fc_b"], approximate="tanh") @ p["out_w"] + p["out_b"]
    return h.transpose(0, 1)


def encoder_forward(
    params: Dict,
    cfg: ModelConfig,
    topic: torch.Tensor,
    image: torch.Tensor,
    text: torch.Tensor,
    use_kernels: bool = False,
    dropout_gen: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``topic`` ``[B, in]``; ``image`` / ``text`` ``[T, B, in]``.
    Returns (topic ``[1, B, H]``, image ``[T, B, H]``, text ``[T, B, H]``).
    ``dropout_gen`` (train only; it draws the masks' seeds) turns on the
    recurrent stacks' inter-layer dropout at ``cfg.dropout`` (the TRM
    channel has none, as in the JAX package); ``use_kernels`` routes
    single-layer GRU channels through the fused GRU kernel and the topic
    product through the batch-invariant one (the inference path)."""
    # the inference path's product through the batch-invariant kernel
    mm = matmul if use_kernels else matmul_plain
    out_topic = mm(topic, params["topic_fc"]["w"], params["topic_fc"]["b"])[None]
    outs = {}
    for name, x, ch in (("image", image, cfg.image), ("text", text, cfg.text)):
        if ch.type == "TRM":
            outs[name] = _trm_forward(params[name], x)
        elif use_kernels and ch.type == "GRU" and ch.num_layers == 1:
            lp = params[name]["layers"][0]
            outs[name] = fused_gru(x, lp["w_ih"], lp["w_hh"], lp["b_ih"],
                                   lp["b_hh"])
        else:
            outs[name], _ = rnn_forward(params[name], x, ch.type,
                                        dropout_rate=cfg.dropout,
                                        dropout_gen=dropout_gen)
    return out_topic, outs["image"], outs["text"]
