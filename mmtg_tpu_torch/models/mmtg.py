"""Top-level MMTG model (:mod:`mmtg_tpu.models.mmtg`): encoder → LN →
alpha ×2 → beta, the WenLan gather, the fused-window addition, the
2048→512→768 projector, the type-id schemes, the teacher-forced train
forwards :func:`mmtg_forward_train` and, over packed rows,
:func:`mmtg_forward_train_packed`, and the no-cache inference forward
:func:`mmtg_forward_infer`."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mmtg_tpu_torch.configs import DataConfig, ModelConfig, SpecialTokens
from mmtg_tpu_torch.models.attention import alpha_attention, beta_attention
from mmtg_tpu_torch.models.encoder import encoder_forward
from mmtg_tpu_torch.models.gpt2 import gpt2_forward, layer_norm

SPECIAL = SpecialTokens()


class MMTGOutput(NamedTuple):
    logits: Optional[torch.Tensor]  # [B, prompt+target, vocab] (None if lm_head=False)
    kl_per_sample: torch.Tensor  # [B] alpha-attention KL (img + text)
    lm_loss: Optional[torch.Tensor]  # HF-style shifted CE (parity aux)
    hidden: Optional[torch.Tensor] = None  # [B, L, n_embd] pre-LM-head states


def encode_experiences(
    params: Dict,
    mcfg: ModelConfig,
    topic_emb: torch.Tensor,
    img_embs: torch.Tensor,
    r_embs: torch.Tensor,
    use_fused_gru: bool = False,
    dropout_gen: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topic_emb`` ``[B, 2048]``; ``img_embs`` / ``r_embs`` ``[B, T,
    2048]``. Returns (fused ``[B, T, 2048]``, kl_per_sample ``[B]``)."""
    dtype = params["encoder"]["topic_fc"]["w"].dtype
    topic_o, image_o, text_o = encoder_forward(
        params["encoder"], mcfg, topic_emb.to(dtype),
        img_embs.to(dtype).transpose(0, 1), r_embs.to(dtype).transpose(0, 1),
        use_fused_gru=use_fused_gru, dropout_gen=dropout_gen,
    )
    ln = lambda x, p: layer_norm(x, p["g"], p["b"], 1e-5)  # noqa: E731
    topic_o = ln(topic_o, params["ln_topic"])  # [1, B, H]
    image_o = ln(image_o, params["ln_image"])  # [T, B, H]
    text_o = ln(text_o, params["ln_text"])
    img_ctx, img_kl = alpha_attention(params["alpha_img"], mcfg,
                                      image_o.transpose(0, 1))
    text_ctx, text_kl = alpha_attention(params["alpha_text"], mcfg,
                                        text_o.transpose(0, 1))
    fused = beta_attention(params["beta"], topic_o[0], img_ctx, text_ctx)
    return fused, img_kl + text_kl


def wenlan_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Dense gather of the ``[vocab, 2048]`` WenLan table."""
    return table[ids]


def add_fused_windows(token_wenlan: torch.Tensor, fused: torch.Tensor,
                      dcfg: DataConfig) -> torch.Tensor:
    """``token_wenlan[:, 44k:44(k+1)] += fused[:, k]`` for k < T; positions
    past the last window get nothing."""
    B, L, E = token_wenlan.shape
    T = fused.shape[1]
    pos = torch.arange(L, device=fused.device) // dcfg.two_sents_length
    gathered = fused[:, pos.clamp(max=T - 1)]  # [B, L, E]
    in_window = (pos < T)[None, :, None]
    return token_wenlan + torch.where(in_window, gathered,
                                      torch.zeros_like(gathered))


def project_to_gpt2(params: Dict, wenlan: torch.Tensor) -> torch.Tensor:
    """2048 → 512 → tanh → 768, in the projector's dtype."""
    w1 = params["projector1"]
    h = torch.tanh(wenlan.to(w1["w"].dtype) @ w1["w"] + w1["b"])
    return h @ params["projector2"]["w"] + params["projector2"]["b"]


def decoder_input_embeds(params: Dict, wenlan_table: torch.Tensor,
                         dcfg: DataConfig, fused: torch.Tensor,
                         topic_ids: torch.Tensor,
                         target_ids: torch.Tensor) -> torch.Tensor:
    """GPT-2 ``inputs_embeds`` for [topic prompt | targets]."""
    topic_wl = wenlan_embed(wenlan_table, topic_ids)
    tgt_wl = add_fused_windows(wenlan_embed(wenlan_table, target_ids), fused,
                               dcfg)
    return project_to_gpt2(params, torch.cat([topic_wl, tgt_wl.to(topic_wl.dtype)],
                                             dim=1))


def train_scheme_type_ids(positions: torch.Tensor, tokens: torch.Tensor,
                          dcfg: DataConfig) -> torch.Tensor:
    """Type ids of the training data: content tokens of sentence pair p get
    p+1 (pair 4 → 1); START/EOS/PAD/SEP slots get 0. ``positions`` index
    the 221-token target grid."""
    frame = dcfg.sent_frame_length
    r = positions % frame
    sent = positions // frame
    pair = sent // 2
    type_id = torch.where(pair == 4, torch.ones_like(pair), pair + 1)
    is_content = (r >= 1) & (r <= dcfg.max_sent_length) & (sent < 10)
    return torch.where(is_content & (tokens != SPECIAL.pad_id), type_id,
                       torch.zeros_like(type_id)).to(torch.int32)


def infer_scheme_type_ids(positions: torch.Tensor, tokens: torch.Tensor,
                          dcfg: DataConfig) -> torch.Tensor:
    """The reference's per-sentence inference scheme: sentence s → s+1
    (s < 10), START/EOS slots and PAD → 0."""
    frame = dcfg.sent_frame_length
    r = positions % frame
    sent = positions // frame
    max_sent_num = dcfg.max_seq_length // frame + 1
    type_id = torch.where(sent < max_sent_num - 1, sent + 1,
                          torch.ones_like(sent))
    is_inner = (r != 0) & (r != frame - 1)
    return torch.where(is_inner & (tokens != SPECIAL.pad_id), type_id,
                       torch.zeros_like(type_id)).to(torch.int32)


def mmtg_forward_train(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    batch: Dict[str, torch.Tensor],
    dropout_gen: Optional[torch.Generator] = None,
    deterministic: bool = True,
    compute_lm_loss: bool = False,
    remat: bool = False,
    attn_impl: str = "auto",
    lm_head: bool = True,
    tp_group=None,
    pp=None,
    remat_policy: str = "full",
) -> MMTGOutput:
    """Teacher-forced forward (:func:`mmtg_tpu.models.mmtg.mmtg_forward_train`).

    ``batch`` uses the reference key names. Returns logits over [topic
    prompt | targets] (or, with ``lm_head=False``, the hidden states for the
    chunked loss) plus the per-sample alpha-attention KL. The encoder runs
    the GRU scan under autograd, never the inference-only fused GRU kernel.
    ``dropout_gen`` with ``deterministic=False`` turns dropout on: the
    encoder draws from it first, then the decoder.

    ``tp_group`` / ``pp`` / ``remat_policy``: the GPT-2 stack
    tensor-parallel or pipelined, and what its remat keeps
    (:func:`~mmtg_tpu_torch.models.gpt2.gpt2_forward`); the encoder, the
    alpha / beta attention and the projector run whole on every rank of a
    data shard, as in the JAX package."""
    gen = dropout_gen if not deterministic else None
    fused, kl = encode_experiences(
        params, mcfg, batch["topic_emb"], batch["img_embs"], batch["r_embs"],
        dropout_gen=gen)
    embeds = decoder_input_embeds(params, const["wenlan_table"], dcfg, fused,
                                  batch["topic_ids"], batch["targets"])
    type_ids = torch.cat([batch["tpw_type_ids"], batch["type_ids"]], dim=1)
    attn_mask = torch.cat([batch["tpw_attention_mask"], batch["attention_mask"]],
                          dim=1)
    L = embeds.shape[1]
    positions = torch.arange(L, device=embeds.device)[None, :]
    out, _ = gpt2_forward(
        params["gpt2"], mcfg.gpt2, embeds, positions, type_ids, attn_mask,
        dropout_gen=gen, deterministic=deterministic, remat=remat,
        attn_impl=attn_impl, lm_head=lm_head, tp_group=tp_group, pp=pp,
        remat_policy=remat_policy)
    if not lm_head:
        return MMTGOutput(logits=None, kl_per_sample=kl, lm_loss=None, hidden=out)
    lm_loss = None
    if compute_lm_loss:
        labels = torch.cat([batch["topic_ids"], batch["targets"]], dim=1)
        logp = torch.log_softmax(out[:, :-1], dim=-1)
        nll = -torch.gather(logp, -1, labels[:, 1:, None].long())
        lm_loss = nll.mean()
    return MMTGOutput(logits=out, kl_per_sample=kl, lm_loss=lm_loss)


def mmtg_forward_train_packed(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    pbatch: Dict[str, torch.Tensor],
    dropout_gen: Optional[torch.Generator] = None,
    deterministic: bool = True,
    remat: bool = False,
    attn_impl: str = "auto",
    lm_head: bool = True,
    tp_group=None,
    pp=None,
    remat_policy: str = "full",
) -> MMTGOutput:
    """Teacher-forced forward over PACKED rows
    (:func:`mmtg_tpu.models.mmtg.mmtg_forward_train_packed`; the rows come
    from :class:`mmtg_tpu_torch.pack.PackedBatcher`).

    The encoder half runs per sample SLOT (``[R, S, ...]`` experience
    tensors, flattened to ``R·S`` encoder rows — empty slots produce garbage
    that ``slot_valid`` masks out of the loss); only the GPT-2 decoder runs
    on the packed token rows, with original-grid position ids, data-provided
    type ids, per-token fused-window gathers and segment-masked attention.
    Explicitly NON-parity (see pack.py's token-accounting contract); the
    parity path is :func:`mmtg_forward_train`. ``kl_per_sample`` is ``[R,
    S]``. ``tp_group`` / ``pp`` / ``remat_policy`` as in
    :func:`mmtg_forward_train` (the trainer packs rows under data
    parallelism only, as the JAX trainer)."""
    gen = dropout_gen if not deterministic else None
    R, S, E = pbatch["topic_emb"].shape
    flat = lambda x: x.reshape((R * S,) + x.shape[2:])  # noqa: E731
    fused, kl = encode_experiences(
        params, mcfg, flat(pbatch["topic_emb"]), flat(pbatch["img_embs"]),
        flat(pbatch["r_embs"]), dropout_gen=gen)  # fused [R·S, W, E], kl [R·S]
    W = fused.shape[1]
    fused = fused.reshape(R, S, W, E)

    token_wl = wenlan_embed(const["wenlan_table"], pbatch["tokens"])  # [R, L, E]
    seg, win = pbatch["seg"], pbatch["win"]
    valid = (seg < S) & (win < W)
    rows = torch.arange(R, device=seg.device)[:, None]
    gathered = fused[rows, seg.clamp(max=S - 1).long(),
                     win.clamp(max=W - 1).long()]  # [R, L, E]
    token_wl = token_wl + torch.where(valid[..., None], gathered,
                                      torch.zeros_like(gathered))
    embeds = project_to_gpt2(params, token_wl)

    out, _ = gpt2_forward(
        params["gpt2"], mcfg.gpt2, embeds, pbatch["positions"],
        pbatch["type_ids"], attention_mask=None, dropout_gen=gen,
        deterministic=deterministic, remat=remat, attn_impl=attn_impl,
        lm_head=lm_head, segment_ids=seg, tp_group=tp_group, pp=pp,
        remat_policy=remat_policy)
    kl = kl.reshape(R, S)
    if not lm_head:
        return MMTGOutput(logits=None, kl_per_sample=kl, lm_loss=None, hidden=out)
    return MMTGOutput(logits=out, kl_per_sample=kl, lm_loss=None)


def mmtg_forward_infer(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    batch: Dict[str, torch.Tensor],
    type_id_scheme: str = "train",
    attn_impl: str = "auto",
) -> MMTGOutput:
    """Non-cached inference forward over a (possibly partial) target prefix
    ``batch["targets"]`` ``[B, K]`` (:func:`mmtg_tpu.models.mmtg.mmtg_forward_infer`):
    the oracle that cached generation is held against, and the no-cache
    baseline a benchmark times.

    Type ids (``"train"`` or ``"reference_infer"`` scheme) and the targets'
    pad mask are computed per row, vectorised. The GPT-2 stack runs with no
    cache and no dropout through ``attn_impl`` (``"auto"``: the train
    attention kernel's forward on the sequence padded to a multiple of 128
    for CUDA tensors, its plain version on the CPU; ``"plain"``: the plain
    version). Returns logits ``[B, 15 + K, V]`` and the alpha KL."""
    fused, kl = encode_experiences(params, mcfg, batch["topic_emb"],
                                   batch["img_embs"], batch["r_embs"])
    targets = batch["targets"]
    embeds = decoder_input_embeds(params, const["wenlan_table"], dcfg, fused,
                                  batch["topic_ids"], targets)
    scheme = (infer_scheme_type_ids if type_id_scheme == "reference_infer"
              else train_scheme_type_ids)
    positions = torch.arange(targets.shape[1], device=targets.device)[None, :]
    tgt_types = scheme(positions, targets, dcfg)
    tgt_mask = (targets != SPECIAL.pad_id).to(torch.int32)
    type_ids = torch.cat([batch["tpw_type_ids"].to(torch.int32), tgt_types], dim=1)
    attn_mask = torch.cat([batch["tpw_attention_mask"].to(torch.int32), tgt_mask],
                          dim=1)
    L = embeds.shape[1]
    logits, _ = gpt2_forward(
        params["gpt2"], mcfg.gpt2, embeds,
        torch.arange(L, device=embeds.device)[None, :], type_ids.long(),
        attn_mask, deterministic=True, attn_impl=attn_impl)
    return MMTGOutput(logits=logits, kl_per_sample=kl, lm_loss=None)
