"""Rating-conditioned sequence-level unlikelihood loss + curriculum masks
(:mod:`mmtg_tpu.loss`, parity rows only; the packed-row losses wait for the
sequence-packing slice).

Vectorized rebuild of the reference ``MyLoss`` (``loss.py:39-74``) and the
trainer's curriculum index-filtering (``train.py:159-186``): every sample
gets a 0/1 *weight* instead of being filtered out, and the loss is a weighted
mean — identical value, one shape for every stage and batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from mmtg_tpu_torch.configs import DataConfig

NEAR_0 = 1e-10


def binarize_ratings(ratings: torch.Tensor, stage) -> torch.Tensor:
    """Stage-dependent rating → y (``loss.py:57-60``): stage 1 keeps only
    rating>4 as positive; later stages use rating>3."""
    return ((ratings > 4) if int(stage) == 1 else (ratings > 3)).float()


def curriculum_sample_weights(ratings: torch.Tensor, stage) -> torch.Tensor:
    """Which samples a stage trains on (``train.py:179-184``):
    stage 1 → rating<2 or >4; stage 2 → rating≠3; stage 3 → all."""
    stage = int(stage)
    if stage == 1:
        return ((ratings < 2) | (ratings > 4)).float()
    if stage == 2:
        return ((ratings < 3) | (ratings > 3)).float()
    return torch.ones_like(ratings, dtype=torch.float32)


def stage_for_epoch(epoch: int, curriculums: Tuple[int, int]) -> int:
    """Curriculum stage schedule (``train.py:159-169``)."""
    if epoch < curriculums[0]:
        return 1
    if epoch < curriculums[1]:
        return 2
    return 3


def _unlikelihood(ce, y, sample_weights):
    """Per-sample CE ``[B]`` → ``-y·log(p) - (1-y)·log(1-p)`` with ``p =
    exp(-CE)``, then the (weighted) batch mean."""
    p = torch.exp(-ce)
    per_sample = -y * torch.log(p + NEAR_0) - (1.0 - y) * torch.log(1.0 - p + NEAR_0)
    if sample_weights is None:
        return per_sample.mean()
    denom = sample_weights.sum().clamp_min(1.0)
    return (per_sample * sample_weights).sum() / denom


def sequence_unlikelihood_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    ratings: torch.Tensor,
    stage,
    dcfg: DataConfig,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference objective (``loss.py:45-74``), vectorized.

    Per sample: CE averaged over the 220 shifted target positions (the
    topic block and final position are dropped; PAD is *not* masked —
    faithful to ``nn.CrossEntropyLoss`` with no ignore_index), then the
    sequence-level NLL. The log-softmax always reduces in f32.

    Args:
      logits: ``[B, topic_prompt+target_len, V]`` full-forward outputs.
      targets: ``[B, target_len]`` token ids.
      sample_weights: optional ``[B]`` 0/1 — curriculum keep-mask ×
        tail-batch padding mask. None → plain mean (reference exact).
    """
    y = binarize_ratings(ratings, stage)
    shift_logits = logits[:, dcfg.topic_prompt_length:-1, :]
    labels = targets[:, 1:].long()
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    token_nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return _unlikelihood(token_nll.mean(dim=-1), y, sample_weights)


def sequence_unlikelihood_loss_from_hidden(
    hidden: torch.Tensor,
    wte: torch.Tensor,
    targets: torch.Tensor,
    ratings: torch.Tensor,
    stage,
    dcfg: DataConfig,
    sample_weights: Optional[torch.Tensor] = None,
    chunk_size: int = 44,
) -> torch.Tensor:
    """Same value as :func:`sequence_unlikelihood_loss`, computed from the
    decoder's pre-LM-head hidden states without materializing the full
    ``[B, T, V]`` logits: each ``[B, chunk, V]`` slice is computed under
    ``torch.utils.checkpoint`` (derived again in the backward), so the
    LM-head matmul runs twice and the loss's peak memory drops by about the
    number of chunks."""
    y = binarize_ratings(ratings, stage)
    h = hidden[:, dcfg.topic_prompt_length:-1, :]
    labels = targets[:, 1:].long()
    B, T, _ = h.shape

    def chunk_nll_sum(h_c, y_c):
        # logits in the compute dtype, softmax reduce in f32 — the full
        # path's numerics
        logp = torch.log_softmax((h_c @ wte.T).float(), dim=-1)
        return -torch.gather(logp, -1, y_c[..., None])[..., 0].sum(dim=-1)

    total_nll = torch.zeros(B, dtype=torch.float32, device=h.device)
    for lo in range(0, T, chunk_size):
        h_c, y_c = h[:, lo:lo + chunk_size], labels[:, lo:lo + chunk_size]
        if torch.is_grad_enabled():
            total_nll = total_nll + torch.utils.checkpoint.checkpoint(
                chunk_nll_sum, h_c, y_c, use_reentrant=False)
        else:
            total_nll = total_nll + chunk_nll_sum(h_c, y_c)
    return _unlikelihood(total_nll / T, y, sample_weights)


def weighted_mean(values: torch.Tensor,
                  weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted batch mean used for the KL term under curriculum masks
    (reference means the KL over the filtered batch, ``train.py:192``)."""
    if weights is None:
        return values.mean()
    return (values * weights).sum() / weights.sum().clamp_min(1.0)
