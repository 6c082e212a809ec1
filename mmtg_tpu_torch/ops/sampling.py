"""Batched repetition penalty / ban / top-k / top-p sampling
(:mod:`mmtg_tpu.ops.sampling`).

The draw is Gumbel-max over the filtered logits, the method of
``jax.random.categorical``, from one of two sources. A ``torch.Generator``
(or ``None``, PyTorch's default generator): one stream for the batch, bits
that differ from JAX's, so sampled tokens match the JAX package only in
distribution (greedy ``top_k=1`` decodes match token for token). Or a
threefry key of :mod:`mmtg_tpu_torch.ops.prng` — one key ``[2]`` for the
batch, or with ``per_row_keys`` one key a row ``[B, 2]``: JAX's own bits, so
float32 decodes sample the JAX engine's tokens, and a row's draw depends on
its key alone.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from mmtg_tpu_torch.configs import SpecialTokens
from mmtg_tpu_torch.ops import prng

NEG_INF = -1e30
SPECIAL = SpecialTokens()
DEFAULT_BANNED = (SPECIAL.start_id, SPECIAL.eos_id, SPECIAL.unk_id, SPECIAL.sep_id)
DEFAULT_PENALTY_EXEMPT = (SPECIAL.pad_id, SPECIAL.sep_id)


def apply_repetition_penalty(logits: torch.Tensor, seen_counts: torch.Tensor,
                             penalty: float,
                             exempt_ids: Sequence[int] = DEFAULT_PENALTY_EXEMPT
                             ) -> torch.Tensor:
    """Divide seen-token logits by ``penalty`` once PER OCCURRENCE
    (``logits / penalty**count``), exempting ``exempt_ids`` — the reference's
    non-deduplicating tensor set."""
    counts = seen_counts.to(logits.dtype, copy=True)
    if exempt_ids:
        counts[:, list(exempt_ids)] = 0
    base = torch.tensor(penalty, dtype=logits.dtype, device=logits.device)
    return logits * torch.pow(base, -counts)


def ban_tokens(logits: torch.Tensor,
               banned_ids: Sequence[int] = DEFAULT_BANNED) -> torch.Tensor:
    logits = logits.clone()
    logits[:, list(banned_ids)] = NEG_INF
    return logits


def _nucleus_mask_sorted(sorted_logits: torch.Tensor,
                         top_p: float) -> torch.Tensor:
    """Keep-first nucleus mask over descending-sorted logits."""
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                       dim=-1)
    return sorted_logits.masked_fill(remove, NEG_INF)


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    """Full-vocabulary top-k threshold + nucleus filter."""
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)[0][..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p > 0.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        sorted_logits = _nucleus_mask_sorted(sorted_logits, top_p)
        logits = torch.empty_like(logits).scatter_(-1, sort_idx, sorted_logits)
    return logits


def _draw(logits: torch.Tensor, generator, per_row_keys: bool = False
          ) -> torch.Tensor:
    """Categorical draw over the last axis by Gumbel-max."""
    if isinstance(generator, torch.Tensor):  # a threefry key, or one a row
        if per_row_keys != (generator.dim() == 2):
            raise ValueError(
                f"sampling: key of shape {tuple(generator.shape)} with "
                f"per_row_keys={per_row_keys} (one key is [2], per-row keys "
                "are [B, 2])")
        return prng.categorical(generator, logits)
    if per_row_keys:
        raise ValueError("sampling: per_row_keys needs threefry keys [B, 2] "
                         "(ops.prng), not a torch.Generator")
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def sample_next_token(
    generator: Union[torch.Generator, torch.Tensor, None],
    logits: torch.Tensor,
    seen_counts: torch.Tensor,
    last_token: torch.Tensor,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    repetition_penalty: float = 1.0,
    topk_impl: str = "exact",
    per_row_keys: bool = False,
) -> torch.Tensor:
    """One sampling step over a batch (reference ``generate.py:124-142``
    order): penalty, temperature, bans, top-k (in the ``[B, k]`` subspace),
    nucleus, draw; a row whose previous token is PAD stays PAD.
    ``generator``: a ``torch.Generator`` / ``None``, or a threefry key
    (``[2]``; with ``per_row_keys`` a batch of keys ``[B, 2]``, each row
    drawing over its candidates from its own key). ``topk_impl="approx"``
    (``lax.approx_max_k`` in the JAX package) takes the exact top-k, which
    is what ``approx_max_k`` computes off the TPU; the TPU's recall-0.99
    partial reduce has no counterpart on the card. Returns ``[B]`` int32
    token ids."""
    if topk_impl not in ("exact", "approx"):
        raise ValueError(f"topk_impl={topk_impl!r}: expected 'exact' or 'approx'")
    if repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, seen_counts,
                                          repetition_penalty)
    logits = ban_tokens(logits / temperature)
    if top_k > 0:
        vals, idx = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)
        if top_p > 0.0:
            vals = _nucleus_mask_sorted(vals, top_p)
        j = _draw(vals, generator, per_row_keys)
        sampled = idx.gather(-1, j[:, None])[:, 0]
    else:
        sampled = _draw(top_k_top_p_filter(logits, top_k, top_p), generator,
                        per_row_keys)
    sampled = sampled.to(torch.int32)
    return torch.where(last_token == SPECIAL.pad_id,
                       torch.full_like(sampled, SPECIAL.pad_id), sampled)


def frame_forced_token(step_index: int, sent_frame_length: int = 22
                       ) -> Tuple[bool, int]:
    """Frame tokens forced at sentence boundaries (``generate.py:118-122``):
    ``[#EOS#]`` when ``(i+2) % 22 == 0`` and ``[#START#]`` when
    ``(i+2) % 22 == 1``, for ``i > 0``. Returns (is_forced, forced_id)."""
    m = (step_index + 2) % sent_frame_length
    if step_index > 0 and m == 0:
        return True, SPECIAL.eos_id
    if step_index > 0 and m == 1:
        return True, SPECIAL.start_id
    return False, 0
