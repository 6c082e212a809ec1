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

With ``use_kernels`` (inference) every product of every channel runs the
batch-invariant kernel (:mod:`mmtg_tpu_torch.ops.matmul`) and the TRM's
LayerNorms the batch-invariant LayerNorm (:mod:`mmtg_tpu_torch.ops.
layer_norm`): a request's channel states do not depend on its batch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mmtg_tpu_torch.configs import ModelConfig
from mmtg_tpu_torch.ops.fused_gru import fused_gru
from mmtg_tpu_torch.ops.layer_norm import layer_norm_rows
from mmtg_tpu_torch.ops.matmul import batched_matmul, matmul, matmul_plain
from mmtg_tpu_torch.ops.rnn import rnn_forward

TRM_LN_EPS = 1e-5


def _trm_ln(v, g, b, eps=TRM_LN_EPS):
    """The JAX TRM block's LayerNorm, in v's dtype."""
    mu = v.mean(dim=-1, keepdim=True)
    var = (v - mu).square().mean(dim=-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps) * g + b


def _trm_forward(p: Dict, x: torch.Tensor, n_head: int = 4,
                 use_kernels: bool = False) -> torch.Tensor:
    """``x`` ``[T, B, in]`` → ``[T, B, D]``: the input projection plus the
    first ``T`` rows of the position table, then one pre-LN block (LayerNorm
    eps 1e-5, ``n_head`` heads attending causally over the steps, masked
    scores set to -1e30, a tanh-approximated GELU MLP), as
    :func:`mmtg_tpu.models.encoder._trm_forward`. ``use_kernels``: the five
    dense products and the two head products through the batch-invariant
    product (the scores at K = head_dim, ``probs @ v`` at K = T on its small
    path), the LayerNorms through the batch-invariant LayerNorm."""
    T, B, _ = x.shape
    if T > p["pos"].shape[0]:
        raise ValueError(f"TRM channel: {T} steps, but its position table "
                         f"has {p['pos'].shape[0]} rows")
    mm = matmul if use_kernels else matmul_plain
    bmm = batched_matmul if use_kernels else torch.matmul
    ln = ((lambda v, g, b: layer_norm_rows(v, g, b, TRM_LN_EPS)) if use_kernels
          else _trm_ln)
    h = mm(x, p["in_proj"]["w"], p["in_proj"]["b"]) + p["pos"][:T][:, None, :]
    h = h.transpose(0, 1)  # [B, T, D]
    D = h.shape[-1]
    hd = D // n_head

    a = ln(h, p["ln1_g"], p["ln1_b"])
    q, k, v = mm(a, p["qkv_w"], p["qkv_b"]).chunk(3, dim=-1)
    q, k, v = (t.reshape(B, T, n_head, hd).transpose(1, 2) for t in (q, k, v))
    scores = bmm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, -1e30)
    ctx = bmm(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(B, T, D)
    h = h + mm(ctx, p["proj_w"]) + p["proj_b"]
    m = ln(h, p["ln2_g"], p["ln2_b"])
    # jax.nn.gelu's default is the tanh approximation
    h = h + mm(F.gelu(mm(m, p["fc_w"], p["fc_b"]), approximate="tanh"),
               p["out_w"]) + p["out_b"]
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
    single-layer GRU channels through the fused GRU kernel and every other
    product and LayerNorm of the encoder through the batch-invariant kernels
    (the inference path)."""
    # the inference path's product through the batch-invariant kernel
    mm = matmul if use_kernels else matmul_plain
    out_topic = mm(topic, params["topic_fc"]["w"], params["topic_fc"]["b"])[None]
    outs = {}
    for name, x, ch in (("image", image, cfg.image), ("text", text, cfg.text)):
        if ch.type == "TRM":
            outs[name] = _trm_forward(params[name], x, use_kernels=use_kernels)
        elif use_kernels and ch.type == "GRU" and ch.num_layers == 1:
            lp = params[name]["layers"][0]
            outs[name] = fused_gru(x, lp["w_ih"], lp["w_hh"], lp["b_ih"],
                                   lp["b_hh"])
        else:
            outs[name], _ = rnn_forward(params[name], x, ch.type,
                                        dropout_rate=cfg.dropout,
                                        dropout_gen=dropout_gen, mm=mm)
    return out_topic, outs["image"], outs["text"]
