"""Inner-modal ("alpha") and multi-modal ("beta") attention fusion
(:mod:`mmtg_tpu.models.attention`), in plain PyTorch."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from mmtg_tpu_torch.configs import ModelConfig


def gaussian_step_priors(seq_len: int = 5) -> np.ndarray:
    """Row-normalized N(i, 1) table: ``prior[i, j] ∝ exp(-(j-i)²/2)``."""
    j = np.arange(seq_len, dtype=np.float64)
    table = np.stack([np.exp(-0.5 * (j - i) ** 2) for i in range(seq_len)])
    table /= table.sum(axis=1, keepdims=True)
    return table.astype(np.float32)


def alpha_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head self-attention over one modality's steps ``x`` ``[B, T,
    H]``. Returns (context ``[B, T, H]``, per-sample KL(prior ‖ attention)
    averaged over steps ``[B]``)."""
    B, T, H = x.shape
    n_head = cfg.self_att_heads
    hd = H // n_head

    def heads(name):
        y = x @ params[name]["w"] + params[name]["b"]
        return y.view(B, T, n_head, hd).transpose(1, 2)

    q, k, v = heads("query"), heads("key"), heads("value")
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)).to(x.dtype)
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)  # [B, h, T, T]
    prior = torch.from_numpy(gaussian_step_priors(T)).to(x.device, probs.dtype)
    log_ratio = torch.log(prior)[None, None] - torch.log(probs)
    kl_per_sample = torch.einsum("ij,bhij->b", prior, log_ratio) / T
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H)
    return ctx, kl_per_sample


def beta_attention(params: Dict, topic: torch.Tensor, image: torch.Tensor,
                   text: torch.Tensor) -> torch.Tensor:
    """Per-step 3-way softmax mix of topic / image_t / text_t states and a
    shared output Linear. ``topic`` ``[B, H]``; ``image`` / ``text`` ``[B,
    T, H]``. Returns ``[B, T, out_dim]``."""
    B, T, H = image.shape
    states = torch.stack([topic[:, None, :].expand(B, T, H), image, text],
                         dim=2)  # [B, T, 3, H]
    scores = (torch.einsum("btmh,thk->btmk", states, params["att_w"])
              + params["att_b"][None, :, None, :])[..., 0]
    mix = torch.softmax(scores, dim=-1)
    fused = torch.einsum("btm,btmh->bth", mix, states)
    return fused @ params["out"]["w"] + params["out"]["b"]
