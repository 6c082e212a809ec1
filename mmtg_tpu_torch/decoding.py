"""Batched KV-cached generation (:mod:`mmtg_tpu.decoding`).

The encoder and the topic-prompt prefill run once per call; then a Python
loop of ``gcfg.length`` (220) steps forces frame tokens, samples (repetition
penalty, bans, top-k / top-p), embeds the token with its WenLan vector plus
the fused experience window, and runs one cached GPT-2 step. For CUDA
tensors that step attends through the hand-written decode-attention kernel
and the encoder runs the fused GRU kernel; for CPU tensors both are their
plain PyTorch versions. That is the only switch.

Same frame / PAD / penalty / mask / type-id semantics as the JAX engine.
Not ported yet (they raise ``NotImplementedError``): per-row seeds
(``row_seeds``), merged k‖v caches, the int4 cache and the whole-step
megakernel (``attn_impl="fused"``), and approximate top-k. The TPU layout
work (sublane padding, ``layer_unroll``, ``score_dtype``) has no
counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mmtg_tpu_torch.configs import DataConfig, GenerateConfig, ModelConfig, SpecialTokens
from mmtg_tpu_torch.models.gpt2 import (
    gpt2_decode_step,
    prefill_cache,
    quantize_decode_weights,
)
from mmtg_tpu_torch.models.mmtg import (
    decoder_input_embeds,
    encode_experiences,
    infer_scheme_type_ids,
    project_to_gpt2,
    train_scheme_type_ids,
    wenlan_embed,
)
from mmtg_tpu_torch.ops.sampling import frame_forced_token, sample_next_token

SPECIAL = SpecialTokens()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_weight_dtype(gcfg: GenerateConfig, batch_size: int) -> str:
    """``'auto'`` → weight-only int8 at B ≤ 32, else the model dtype. The
    threshold is the JAX package's, kept for parity until it is measured
    on the H100."""
    if gcfg.weight_dtype != "auto":
        return gcfg.weight_dtype
    return "int8" if batch_size <= 32 else "model"


def resolve_cache_dtype(gcfg: GenerateConfig, batch_size: int) -> str:
    """``'auto'`` → int8 KV cache at B ≥ 2, the model dtype at B = 1 (the
    JAX package's threshold, kept for parity until measured on the H100)."""
    if gcfg.cache_dtype != "auto":
        return gcfg.cache_dtype
    return "model" if batch_size <= 1 else "int8"


def _check_scope(gcfg: GenerateConfig, cache_dtype: str) -> None:
    if cache_dtype not in ("model", "int8"):
        raise NotImplementedError(f"cache_dtype={cache_dtype!r} is not ported")
    if gcfg.merged_kv:
        raise NotImplementedError("merged_kv is not ported")
    if gcfg.attn_impl == "fused":
        raise NotImplementedError(
            "attn_impl='fused' (the whole-step megakernel) is not ported")


def _scheme(gcfg: GenerateConfig):
    return (infer_scheme_type_ids if gcfg.type_id_scheme == "reference_infer"
            else train_scheme_type_ids)


def _prefill(params, table, mcfg, dcfg, batch, fused, first_tok, capacity,
             cache_dtype):
    """Topic prompt + first target token through the prefill; returns
    (last-position logits, cache, key_mask)."""
    B = first_tok.shape[0]
    P = dcfg.topic_prompt_length
    dev = first_tok.device
    embeds = decoder_input_embeds(params, table, dcfg, fused,
                                  batch["topic_ids"], first_tok[:, None])
    type_ids = torch.cat([batch["tpw_type_ids"].to(torch.int64),
                          torch.zeros(B, 1, dtype=torch.int64, device=dev)], 1)
    attn_mask = torch.cat([batch["tpw_attention_mask"].to(torch.int32),
                           torch.ones(B, 1, dtype=torch.int32, device=dev)], 1)
    logits, cache = prefill_cache(
        params["gpt2"], mcfg.gpt2, embeds, torch.arange(P + 1, device=dev),
        type_ids, attn_mask, capacity, cache_dtype)
    key_mask = torch.zeros(B, capacity, dtype=torch.int32, device=dev)
    key_mask[:, :P + 1] = attn_mask
    return logits[:, -1], cache, key_mask


def _step_embed(params, table, dcfg, fused, gcfg, tok, j):
    """Embedding and type id of target token ``tok`` at target position
    ``j``: WenLan vector + its fused window (none past the last one)."""
    wl = wenlan_embed(table, tok)
    T_steps = fused.shape[1]
    if j < dcfg.two_sents_length * T_steps:
        wl = wl + fused[:, min(j // dcfg.two_sents_length, T_steps - 1)]
    x = project_to_gpt2(params, wl)
    pos = torch.full_like(tok, j)
    return x, _scheme(gcfg)(pos, tok, dcfg).to(torch.int64)


@torch.no_grad()
def generate(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    gcfg: GenerateConfig,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    row_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generate lyrics for a whole batch.

    Args:
      batch: ``topic_ids``, ``tpw_attention_mask``, ``tpw_type_ids``
        ``[B, 15]``; ``topic_emb`` ``[B, 2048]``; ``img_embs`` / ``r_embs``
        ``[B, 5, 2048]`` — tensors on the device the params live on.
      generator: the ``torch.Generator`` (on that device) every draw comes
        from; ``None`` uses PyTorch's default generator.
    Returns:
      ``[B, 1 + length]`` int32 token ids, position 0 = ``[#START#]``.
    """
    if row_seeds is not None:
        raise NotImplementedError("per-row seeds (row_seeds) are not ported")
    table = const["wenlan_table"]
    B = batch["topic_ids"].shape[0]
    dev = batch["topic_ids"].device
    V = mcfg.gpt2.vocab_size
    P = dcfg.topic_prompt_length
    cache_dtype = resolve_cache_dtype(gcfg, B)
    _check_scope(gcfg, cache_dtype)
    capacity = _round_up(P + gcfg.length + 1, 128)

    fused, _ = encode_experiences(params, mcfg, batch["topic_emb"],
                                  batch["img_embs"], batch["r_embs"],
                                  use_fused_gru=True)
    start = torch.full((B,), SPECIAL.start_id, dtype=torch.int64, device=dev)
    last_logits, cache, key_mask = _prefill(
        params, table, mcfg, dcfg, batch, fused, start, capacity, cache_dtype)
    gpt2_params = params["gpt2"]
    if resolve_weight_dtype(gcfg, B) == "int8":
        gpt2_params = quantize_decode_weights(gpt2_params)

    tokens = torch.zeros(B, gcfg.length + 1, dtype=torch.int32, device=dev)
    tokens[:, 0] = SPECIAL.start_id
    # per-row occurrence counts (the penalty applies once per occurrence)
    seen = torch.zeros(B, V, dtype=torch.int16, device=dev)
    seen[:, SPECIAL.start_id] = 1
    rows = torch.arange(B, device=dev)
    for i in range(gcfg.length):
        is_forced, forced_id = frame_forced_token(i, dcfg.sent_frame_length)
        if is_forced:
            tok = torch.full((B,), forced_id, dtype=torch.int64, device=dev)
        else:
            tok = sample_next_token(
                generator, last_logits, seen, tokens[:, i],
                temperature=gcfg.temperature, top_k=gcfg.top_k,
                top_p=gcfg.top_p, repetition_penalty=gcfg.repetition_penalty,
                topk_impl=gcfg.topk_impl,
            ).to(torch.int64)
        j = i + 1
        tokens[:, j] = tok.to(torch.int32)
        seen[rows, tok] += 1
        x, tt = _step_embed(params, table, dcfg, fused, gcfg, tok, j)
        key_mask[:, P + j] = (tok != SPECIAL.pad_id).to(torch.int32)
        last_logits = gpt2_decode_step(gpt2_params, mcfg.gpt2, cache, x, P + j,
                                       tt, key_mask)
    return tokens


@torch.no_grad()
def teacher_forced_decode_logits(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    gcfg: GenerateConfig,
    batch: Dict[str, torch.Tensor],
    tokens: torch.Tensor,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Per-step logits of the cached decode engine under teacher forcing:
    ``tokens`` ``[B, K]`` (position 0 = ``[#START#]``) go through the same
    prefill + per-token cached step the sampler uses; returns ``[B, K, V]``
    where row ``j`` predicts the token after ``tokens[:, :j+1]``.

    ``use_kernels=False`` runs the plain PyTorch versions of the kernels on
    any device — the reference the kernel path is held against."""
    table = const["wenlan_table"]
    B, K = tokens.shape
    P = dcfg.topic_prompt_length
    cache_dtype = resolve_cache_dtype(gcfg, B)
    _check_scope(gcfg, cache_dtype)
    capacity = _round_up(P + K + 1, 128)
    tokens = tokens.to(torch.int64)
    fused, _ = encode_experiences(params, mcfg, batch["topic_emb"],
                                  batch["img_embs"], batch["r_embs"],
                                  use_fused_gru=use_kernels)
    logits, cache, key_mask = _prefill(
        params, table, mcfg, dcfg, batch, fused, tokens[:, 0], capacity,
        cache_dtype)
    out = [logits]
    for j in range(1, K):
        tok = tokens[:, j]
        x, tt = _step_embed(params, table, dcfg, fused, gcfg, tok, j)
        key_mask[:, P + j] = (tok != SPECIAL.pad_id).to(torch.int32)
        out.append(gpt2_decode_step(params["gpt2"], mcfg.gpt2, cache, x, P + j,
                                    tt, key_mask, use_kernels=use_kernels))
    return torch.stack(out, dim=1)


def postprocess_tokens(token_ids, tokenizer) -> str:
    """Host-side cleanup of one generated row (``generate.py:222-235``):
    cut at the 10th ``[#EOS#]`` (or first ``[SEP]``), strip specials, join
    sentences with '，'. Byte-level BPE vocabularies decode through the
    tokenizer's ``byte_decoder``."""
    toks = tokenizer.convert_ids_to_tokens([int(t) for t in token_ids])
    eos_idx = [i for i, v in enumerate(toks) if v == "[#EOS#]"]
    if len(eos_idx) >= 10 and "[SEP]" not in toks[: eos_idx[-1]]:
        toks = toks[: eos_idx[9] + 1] + ["[SEP]"]
    elif "[SEP]" in toks:
        toks = toks[: toks.index("[SEP]") + 1]
    else:
        toks = toks + ["[SEP]"]
    byte_decoder = getattr(tokenizer, "byte_decoder", None)

    def join(chunk):
        s = "".join(chunk)
        if byte_decoder is None:
            return s
        return bytes(byte_decoder[c] for c in s if c in byte_decoder).decode(
            "utf-8", errors="replace")

    sents, cur = [], []
    for t in toks:
        if t == "[#EOS#]":
            sents.append(join(cur))
            cur = []
        elif t not in ("[SEP]", "[PAD]", "[#START#]"):
            cur.append(t)
    if cur:
        sents.append(join(cur))
    while sents and not sents[-1]:
        sents.pop()
    return "，".join(sents)
