"""Inner-modal ("alpha") and multi-modal ("beta") attention fusion
(:mod:`mmtg_tpu.models.attention`), in plain PyTorch."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from mmtg_tpu_torch.configs import ModelConfig
from mmtg_tpu_torch.ops.matmul import batched_matmul, matmul, matmul_plain


def gaussian_step_priors(seq_len: int = 5) -> np.ndarray:
    """Row-normalized N(i, 1) table: ``prior[i, j] ∝ exp(-(j-i)²/2)``."""
    j = np.arange(seq_len, dtype=np.float64)
    table = np.stack([np.exp(-0.5 * (j - i) ** 2) for i in range(seq_len)])
    table /= table.sum(axis=1, keepdims=True)
    return table.astype(np.float32)


def alpha_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    use_kernels: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head self-attention over one modality's steps ``x`` ``[B, T,
    H]``. Returns (context ``[B, T, H]``, per-sample KL(prior ‖ attention)
    averaged over steps ``[B]``). ``use_kernels``: the products through the
    batch-invariant kernel (:mod:`mmtg_tpu_torch.ops.matmul`; no gradient)."""
    B, T, H = x.shape
    n_head = cfg.self_att_heads
    hd = H // n_head
    mm = matmul if use_kernels else matmul_plain
    bmm = batched_matmul if use_kernels else torch.matmul

    def heads(name):
        y = mm(x, params[name]["w"], params[name]["b"])
        return y.view(B, T, n_head, hd).transpose(1, 2)

    q, k, v = heads("query"), heads("key"), heads("value")
    scores = bmm(q.float(), k.float().transpose(-1, -2)).to(x.dtype)
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)  # [B, h, T, T]
    prior = torch.from_numpy(gaussian_step_priors(T)).to(x.device, probs.dtype)
    log_ratio = torch.log(prior)[None, None] - torch.log(probs)
    kl_per_sample = torch.einsum("ij,bhij->b", prior, log_ratio) / T
    ctx = bmm(probs, v).transpose(1, 2).reshape(B, T, H)
    return ctx, kl_per_sample


def beta_attention(params: Dict, topic: torch.Tensor, image: torch.Tensor,
                   text: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
    """Per-step 3-way softmax mix of topic / image_t / text_t states and a
    shared output Linear. ``topic`` ``[B, H]``; ``image`` / ``text`` ``[B,
    T, H]``. Returns ``[B, T, out_dim]``. ``use_kernels``: the products
    through the batch-invariant kernel (no gradient)."""
    mm = matmul if use_kernels else matmul_plain
    bmm = batched_matmul if use_kernels else torch.matmul
    B, T, H = image.shape
    states = torch.stack([topic[:, None, :].expand(B, T, H), image, text],
                         dim=2)  # [B, T, 3, H]
    # step t's [B x 3, H] states by its own [H, k] scorer (its first column
    # read), then the mix as a [1, 3] @ [3, H] product a (row, step)
    per_step = states.transpose(0, 1).reshape(T, B * 3, H)
    scores = (bmm(per_step, params["att_w"])[..., 0].view(T, B, 3).transpose(0, 1)
              + params["att_b"][None, :, 0:1])
    mix = torch.softmax(scores, dim=-1)
    fused = bmm(mix.reshape(B * T, 1, 3), states.reshape(B * T, 3, H)).view(B, T, H)
    return mm(fused, params["out"]["w"], params["out"]["b"])
