"""GPT-2 decoder (:mod:`mmtg_tpu.models.gpt2`).

Parameters keep the JAX package's stacked layout: ``params["h"][name]`` is
``[L, ...]`` and every weight is applied as ``x @ W`` (HF ``Conv1D``
orientation). Learned position embeddings, token-type ids embedded with the
word embedding matrix, pre-LN blocks with fused QKV, ``gelu_new``, final LN,
weight-tied head.

The full-sequence forward (:func:`gpt2_forward`) serves training (dropout,
per-block remat, attention through the hand-written train-attention kernels,
:mod:`mmtg_tpu_torch.ops.train_attention`, with a key-padding mask or, for
packed rows, segment ids) and the prefill (:func:`prefill_cache`, plain
PyTorch attention — the JAX package runs XLA attention there too). No tensor
/ pipeline parallelism, no selective remat policies. The one-token decode
step (:func:`gpt2_decode_step`) attends, for CUDA tensors, through the
hand-written decode-attention kernel
(:mod:`mmtg_tpu_torch.ops.decode_attention`: full-precision, int8, int4 and
merged k‖v caches) or, with ``attn_impl="fused"``, runs all its layers in
the whole-step kernel (:mod:`mmtg_tpu_torch.ops.decode_megakernel`).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from mmtg_tpu_torch.configs import GPT2Config
from mmtg_tpu_torch.ops.decode_attention import (
    NEG_INF,
    decode_attention_append_plain,
    decode_attention_fp_append,
    decode_attention_int4_append,
    decode_attention_int8_append,
    decode_attention_int8_append_merged,
    quantize_rows,
    quantize_rows_int4,
    true_div,
    unpack_int4,
)
from mmtg_tpu_torch.ops.decode_megakernel import (
    decode_block_fused,
    decode_block_fused_plain,
)
from mmtg_tpu_torch.ops.train_attention import (
    mha_train,
    mha_train_packed,
    mha_train_packed_plain,
    mha_train_packed_seg,
    mha_train_packed_seg_plain,
    pad_proj_weights,
    pad_qkv_weights,
)

__all__ = [
    "KVCache", "quantize_rows", "quantize_rows_int4", "unpack_int4",
    "layer_norm", "gelu_new", "gpt2_forward", "init_cache", "merge_kv",
    "prefill_cache", "gpt2_decode_step", "import_hf_gpt2",
    "quantize_decode_weights",
]


class KVCache(NamedTuple):
    """Fixed-capacity KV cache ``[L, B, T_max, row]`` (heads merged into D).

    Quantized when ``k_scale`` / ``v_scale`` (``[L, B, T_max]`` f32 per-row
    abs-max scales) are set — int8 (``row = D``) or int4 (``row = D/2``, two
    codes a byte) — else in the model dtype. ``merged``: ``k`` is the
    ``[L, B, T_max, 2D]`` int8 k‖v buffer (k in the low lane half) and ``v``
    is ``None`` (the JAX package marks this form by a zero-size ``v``).
    Unlike the JAX version the tensors are updated IN PLACE by
    :func:`gpt2_decode_step`."""

    k: torch.Tensor
    v: Optional[torch.Tensor]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    merged: bool = False

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def kind(self, n_embd: int) -> str:
        """``"model"``, ``"int8"`` or ``"int4"`` (told by the packed row)."""
        if not self.quantized:
            return "model"
        return "int4" if not self.merged and self.k.shape[-1] * 2 == n_embd else "int8"


_CACHE_KINDS = ("model", "int8", "int4")


def init_cache(cfg: GPT2Config, batch: int, capacity: int,
               dtype: torch.dtype = torch.float32, cache_dtype: str = "model",
               device="cpu") -> KVCache:
    """An empty cache of ``capacity`` slots (:func:`mmtg_tpu.models.gpt2.
    init_cache`): ``cache_dtype`` ``"model"`` (``dtype``), ``"int8"`` or
    ``"int4"`` (rows of ``n_embd / 2`` bytes)."""
    if cache_dtype not in _CACHE_KINDS:
        raise ValueError(f"unknown cache kind {cache_dtype!r}")
    D = cfg.n_embd // 2 if cache_dtype == "int4" else cfg.n_embd
    shape = (cfg.n_layer, batch, capacity, D)
    if cache_dtype == "model":
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
    return KVCache(*(torch.zeros(shape, dtype=torch.int8, device=device)
                     for _ in range(2)),
                   *(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                     for _ in range(2)))


def merge_kv(cache: KVCache) -> KVCache:
    """The int8 split cache as one ``[L, B, T, 2D]`` k‖v buffer (one
    concatenation, made once per ``generate`` call after the prefill)."""
    if not cache.quantized or cache.merged or cache.k.shape != cache.v.shape \
            or cache.k.dtype != torch.int8:
        raise ValueError("merge_kv: an int8 split cache is needed")
    return KVCache(torch.cat([cache.k, cache.v], dim=-1), None, cache.k_scale,
                   cache.v_scale, merged=True)


def layer_norm(x, g, b, eps):
    """The JAX package's LayerNorm numerics: row statistics accumulate in
    f32, elementwise math stays in x's dtype."""
    mean = x.float().mean(dim=-1, keepdim=True)
    xm = x - mean.to(x.dtype)
    var = xm.square().float().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps).to(x.dtype)
    return xm * rstd * g + b


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * torch.pow(x, 3.0))))


def _dropout(x, rate: float, seed):
    """Inverted dropout from a 16-bit threshold compare, scaled by the
    realised keep probability ``(65536 - thr) / 65536`` (the JAX package's
    ``_dropout`` rule; the bits themselves differ). The mask is a pure
    function of ``seed`` (a Python int) and x's shape and device, so a
    block recomputed under ``torch.utils.checkpoint`` draws it again
    identically. ``seed=None`` or ``rate <= 0`` returns x."""
    if seed is None or rate <= 0.0:
        return x
    thr = int(round(rate * 65536.0))
    keep_p = (65536 - thr) / 65536.0
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    bits = torch.randint(0, 65536, x.shape, generator=gen, device=x.device,
                         dtype=torch.int32)
    return torch.where(bits >= thr, x / keep_p, torch.zeros_like(x))


_ATTN_IMPLS = {"auto": "kernel", "kernel": "kernel",
               "kernel_padded": "kernel_padded", "plain": "plain"}
# the segment id of the slots that pad a packed row to a multiple of 128: they
# see only themselves (finite softmax rows) and never mix with real tokens
PAD_SEGMENT = 2 ** 15


def gpt2_forward(
    params: Dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    dropout_gen: Optional[torch.Generator] = None,
    deterministic: bool = True,
    remat: bool = False,
    attn_impl: str = "auto",
    lm_head: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Full-sequence forward (train / prefill / teacher forcing).

    Args:
      inputs_embeds: ``[B, T, D]``; position_ids ``[B, T]`` or ``[T]``;
      token_type_ids ``[B, T]`` (embedded via ``wte``); attention_mask
      ``[B, T]`` 1/0 key padding.
      dropout_gen / deterministic: with a generator and ``deterministic=
        False`` the embedding, attention and residual dropouts are on, at
        the config's rates. Every mask's seed is drawn from the generator
        BEFORE the layer loop, so ``remat`` recomputes identical masks.
      remat: recompute each block in the backward
        (``torch.utils.checkpoint``) instead of keeping its activations.
      attn_impl: ``"kernel"`` (also ``"auto"``, the default) runs
        :func:`mmtg_tpu_torch.ops.train_attention.mha_train_packed` — the
        hand-written kernel pair for CUDA tensors, which raises on what it
        does not take (``head_dim > 128``) — on the sequence padded once to
        a multiple of 128; ``"kernel_padded"`` folds a per-head pad to 128
        lanes into the QKV and output-projection weights and runs
        :func:`~mmtg_tpu_torch.ops.train_attention.mha_train` on the
        head-major slab (the JAX package's ``"pallas"``); ``"plain"`` runs
        the packed kernel's plain version on the same padded sequence. None
        applies with ``return_kv``: the prefill keeps each layer's k/v, has
        no dropout, and materializes the ``[B, 1, T, T]`` bias and soft-maxes
        in the activations' dtype, as the JAX package's prefill does.
      lm_head: ``False`` returns the final hidden states ``[B, T, D]``
        (for the chunked loss) instead of logits.
      segment_ids: ``[B, T]`` ids of packed rows
        (:mod:`mmtg_tpu_torch.pack`): attention is causal within equal ids
        and blocked across them; replaces ``attention_mask``. Train path
        only (raises with ``return_kv``). Both kernel values then run
        :func:`~mmtg_tpu_torch.ops.train_attention.mha_train_packed_seg`
        (only the standard slab takes segment ids, as in the JAX package),
        ``"plain"`` its plain version.
    Returns:
      (logits ``[B, T, V]`` or hidden, per-layer (k, v) each ``[L, B, T,
      D]`` when ``return_kv``).
    """
    if attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: one of {sorted(_ATTN_IMPLS)}")
    attn_impl = _ATTN_IMPLS[attn_impl]
    B, T, D = inputs_embeds.shape
    L = cfg.n_layer
    h = inputs_embeds + params["wpe"][position_ids]
    if token_type_ids is not None:
        h = h + params["wte"][token_type_ids]

    dropout = dropout_gen is not None and not deterministic
    if return_kv and dropout:
        raise ValueError("gpt2_forward: return_kv (the prefill) has no dropout")
    if return_kv and segment_ids is not None:
        raise ValueError("gpt2_forward: segment_ids is train-path only (no "
                         "return_kv)")
    embd_seed, layer_seeds, attn_seeds = None, [(None, None)] * L, None
    if dropout:
        draws = torch.randint(0, 2 ** 31 - 1, (1 + 3 * L,), generator=dropout_gen,
                              device=dropout_gen.device).cpu()
        embd_seed = int(draws[0])
        layer_seeds = [(int(draws[2 + 3 * l]), int(draws[3 + 3 * l]))
                       for l in range(L)]
        attn_seeds = draws[1::3].to(device=h.device, dtype=torch.int32)
        h = _dropout(h, cfg.embd_pdrop, embd_seed)
    attn_rate = cfg.attn_pdrop if dropout else 0.0

    hd = cfg.head_dim
    n_head = D // hd
    T_real = T
    if return_kv:
        scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=h.dtype,
                                              device=h.device))
        causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
        bias = torch.zeros(T, T, dtype=h.dtype, device=h.device).masked_fill(
            ~causal, NEG_INF)[None, None]
        if attention_mask is not None:
            pad = (1.0 - attention_mask.to(h.dtype)) * NEG_INF
            bias = bias + pad[:, None, None, :]
    else:
        # the sequence is padded once to a multiple of 128 for the whole
        # stack; padded keys get a -1e30 bias (or their own segment), padded
        # query rows are cut
        Tp = ((T + 127) // 128) * 128
        if Tp != T:
            h = torch.nn.functional.pad(h, (0, 0, 0, Tp - T))
        if segment_ids is not None:
            attend = (mha_train_packed_seg_plain if attn_impl == "plain"
                      else mha_train_packed_seg)
            if attn_impl == "kernel_padded":
                attn_impl = "kernel"  # only the standard slab takes segments
            bias = torch.nn.functional.pad(  # [B, Tp] segment ids
                segment_ids.to(torch.int32), (0, Tp - T),
                value=PAD_SEGMENT).contiguous()
        else:
            attend = {"kernel": mha_train_packed, "kernel_padded": mha_train,
                      "plain": mha_train_packed_plain}[attn_impl]
            mask = (attention_mask.to(torch.float32)
                    if attention_mask is not None
                    else torch.ones(B, T, dtype=torch.float32, device=h.device))
            mask = torch.nn.functional.pad(mask, (0, Tp - T))
            bias = ((1.0 - mask) * NEG_INF).contiguous()  # [B, Tp] key bias
        if attn_seeds is None:
            attn_seeds = torch.zeros(L, dtype=torch.int32, device=h.device)
        T = Tp

    p = params["h"]
    eps = cfg.layer_norm_epsilon

    def block(h, l):
        k_resid1, k_resid2 = layer_seeds[l]
        a = layer_norm(h, p["ln1_g"][l], p["ln1_b"][l], eps)
        k = v = None
        w_proj = p["attn_proj_w"][l]
        if return_kv:
            q, k, v = (a @ p["attn_w"][l] + p["attn_b"][l]).split(D, dim=-1)
            qh, kh, vh = (t.view(B, T, n_head, hd).transpose(1, 2)
                          for t in (q, k, v))
            # f32-accumulated score dot, then the model dtype (as the JAX
            # einsum with preferred_element_type=f32)
            scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
            probs = torch.softmax(scores.to(h.dtype) * scale + bias, dim=-1)
            ctx = torch.matmul(probs, vh).transpose(1, 2).reshape(B, T, D)
        else:
            # the projection bias is added inside the attention function
            w_qkv, b_qkv = p["attn_w"][l], p["attn_b"][l]
            if attn_impl == "kernel_padded":
                w_qkv, b_qkv = pad_qkv_weights(w_qkv, b_qkv, n_head, hd)
                w_proj = pad_proj_weights(w_proj, n_head, hd)
            ctx = attend(a @ w_qkv, b_qkv, bias, attn_seeds[l:l + 1], n_head,
                         attn_rate, 1.0 / math.sqrt(hd))
        attn_out = ctx @ w_proj + p["attn_proj_b"][l]
        h = h + _dropout(attn_out, cfg.resid_pdrop, k_resid1)
        m = layer_norm(h, p["ln2_g"][l], p["ln2_b"][l], eps)
        m = gelu_new(m @ p["mlp_fc_w"][l] + p["mlp_fc_b"][l])
        m = m @ p["mlp_proj_w"][l] + p["mlp_proj_b"][l]
        return h + _dropout(m, cfg.resid_pdrop, k_resid2), k, v

    ks, vs = [], []
    for l in range(L):
        if remat and torch.is_grad_enabled():
            # masks are functions of their seeds, so the generators' global
            # state need not be saved and restored
            h, k, v = torch.utils.checkpoint.checkpoint(
                block, h, l, use_reentrant=False, preserve_rng_state=False)
        else:
            h, k, v = block(h, l)
        if return_kv:
            ks.append(k)
            vs.append(v)
    if T != T_real:
        h = h[:, :T_real]
    h = layer_norm(h, params["lnf_g"], params["lnf_b"], eps)
    kv = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    if not lm_head:
        return h, kv
    return h @ params["wte"].T, kv


def prefill_cache(
    params: Dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    token_type_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    capacity: int,
    cache_dtype: str = "model",
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt once; return its logits and a cache of ``capacity``
    slots holding the prompt's k/v (``cache_dtype`` ``"model"``, ``"int8"``
    or ``"int4"``)."""
    if cache_dtype not in _CACHE_KINDS:
        raise ValueError(f"unknown cache kind {cache_dtype!r}")
    logits, (k, v) = gpt2_forward(params, cfg, inputs_embeds, position_ids,
                                  token_type_ids, attention_mask,
                                  return_kv=True)
    L, B, T, D = k.shape

    def padded(x):
        out = torch.zeros((L, B, capacity) + x.shape[3:], dtype=x.dtype,
                          device=x.device)
        out[:, :, :T] = x
        return out

    if cache_dtype != "model":
        quant = quantize_rows_int4 if cache_dtype == "int4" else quantize_rows
        kq, ks = quant(k)
        vq, vs = quant(v)
        return logits, KVCache(padded(kq), padded(vq), padded(ks), padded(vs))
    return logits, KVCache(padded(k), padded(v))


def _mm(x, p, l, key):
    """``x @ W`` for layer ``l``; weight-only int8 (``key_q`` / ``key_s``
    from :func:`quantize_decode_weights`) dequantizes in the matmul's
    epilogue, in f32, then casts back to x's dtype."""
    if key + "_q" in p:
        return ((x @ p[key + "_q"][l].to(x.dtype)) * p[key + "_s"][l]).to(x.dtype)
    return x @ p[key][l]


def gpt2_decode_step(
    params: Dict,
    cfg: GPT2Config,
    cache: KVCache,
    x_embed: torch.Tensor,
    position: int,
    token_type_id: torch.Tensor,
    key_mask: torch.Tensor,
    use_kernels: bool = True,
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """One-token KV-cached decode step; returns logits ``[B, V]``.

    The new token's k/v are written into the cache at ``position`` (in
    place) before attending over slots ``<= position`` with ``key_mask``
    ``[B, T_max]`` int32 != 0. The cache's form picks the attention: full
    precision, int8, int4, or the merged int8 k‖v buffer.
    ``attn_impl="fused"`` runs all layers in the whole-step kernel instead
    of the per-layer loop; it needs an int8 split cache and full-precision
    weights and raises otherwise (``decoding.resolve_attn_impl`` gates it).
    ``use_kernels=False`` runs the plain PyTorch versions on any device (a
    reference for the kernel path).
    """
    if attn_impl not in ("kernel", "fused"):
        raise ValueError(f"attn_impl {attn_impl!r}: 'kernel' or 'fused'")
    D = x_embed.shape[-1]
    n_head = D // cfg.head_dim
    p = params["h"]
    kind = cache.kind(D)
    h = x_embed + params["wpe"][position] + params["wte"][token_type_id]
    if attn_impl == "fused":
        if kind != "int8" or cache.merged or "attn_w_q" in p:
            raise ValueError("attn_impl='fused' needs an int8 split cache and "
                             "full-precision weights")
        block = decode_block_fused if use_kernels else decode_block_fused_plain
        h = block(h.contiguous(), p, cache.k, cache.v, cache.k_scale,
                  cache.v_scale, key_mask, position, n_head=n_head,
                  eps=cfg.layer_norm_epsilon)
    else:
        h = _decode_layers(p, cfg, cache, h, position, key_mask, use_kernels,
                           kind, n_head)
    h = layer_norm(h, params["lnf_g"], params["lnf_b"], cfg.layer_norm_epsilon)
    if "wte_q" in params:
        return ((h @ params["wte_q"].T.to(h.dtype)) * params["wte_s"].T).to(h.dtype)
    return h @ params["wte"].T


def _decode_layers(p, cfg, cache, h, position, key_mask, use_kernels, kind,
                   n_head):
    """The per-layer decode loop: one append + attention call a layer."""
    D = h.shape[-1]
    scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if not use_kernels:
        attend = functools.partial(decode_attention_append_plain,
                                   k_cache=cache.k, v_cache=cache.v, **scales)
    elif cache.merged:
        attend = functools.partial(decode_attention_int8_append_merged,
                                   kv_cache=cache.k, **scales)
    elif kind == "model":
        attend = functools.partial(decode_attention_fp_append,
                                   k_cache=cache.k, v_cache=cache.v)
    else:
        attend = functools.partial(
            decode_attention_int4_append if kind == "int4"
            else decode_attention_int8_append,
            k_cache=cache.k, v_cache=cache.v, **scales)
    for l in range(cfg.n_layer):
        a = layer_norm(h, p["ln1_g"][l], p["ln1_b"][l], cfg.layer_norm_epsilon)
        q, k, v = (_mm(a, p, l, "attn_w") + p["attn_b"][l]).split(D, dim=-1)
        ctx = attend(q.contiguous(), k.contiguous(), v.contiguous(),
                     key_mask=key_mask, position=position, layer=l,
                     n_head=n_head)
        h = h + _mm(ctx, p, l, "attn_proj_w") + p["attn_proj_b"][l]
        m = layer_norm(h, p["ln2_g"][l], p["ln2_b"][l], cfg.layer_norm_epsilon)
        m = gelu_new(_mm(m, p, l, "mlp_fc_w") + p["mlp_fc_b"][l])
        h = h + _mm(m, p, l, "mlp_proj_w") + p["mlp_proj_b"][l]
    return h


def quantize_decode_weights(params: Dict) -> Dict:
    """Weight-only int8 for the decode loop
    (:func:`mmtg_tpu.models.gpt2.quantize_decode_weights`): per-output-
    channel abs-max over the four glue matmuls (``[L, in, out]`` → scales
    ``[L, 1, out]``) and per-vocab-row over ``wte`` (scales ``[V, 1]``).
    The full-precision weights stay in the returned dict."""
    out = dict(params)
    h = dict(params["h"])

    def q(w, dim):
        w = w.float()
        s = true_div(w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8), 127.0)
        return torch.round(w / s).clamp(-127, 127).to(torch.int8), s

    for key in ("attn_w", "attn_proj_w", "mlp_fc_w", "mlp_proj_w"):
        h[key + "_q"], h[key + "_s"] = q(h[key], 1)
    out["h"] = h
    out["wte_q"], out["wte_s"] = q(params["wte"], 1)
    return out


_HF_LAYER_NAMES = {
    "ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias",
    "attn_w": "attn.c_attn.weight", "attn_b": "attn.c_attn.bias",
    "attn_proj_w": "attn.c_proj.weight", "attn_proj_b": "attn.c_proj.bias",
    "ln2_g": "ln_2.weight", "ln2_b": "ln_2.bias",
    "mlp_fc_w": "mlp.c_fc.weight", "mlp_fc_b": "mlp.c_fc.bias",
    "mlp_proj_w": "mlp.c_proj.weight", "mlp_proj_b": "mlp.c_proj.bias",
}


def import_hf_gpt2(state_dict: Dict[str, torch.Tensor], cfg: GPT2Config,
                   prefix: str = "") -> Dict:
    """HF ``GPT2LMHeadModel`` state dict → the stacked layout (HF
    ``Conv1D`` weights are already ``[in, out]``: no transposes)."""
    get = lambda name: torch.as_tensor(state_dict[prefix + name]).detach()  # noqa: E731
    return {
        "wte": get("transformer.wte.weight").clone(),
        "wpe": get("transformer.wpe.weight").clone(),
        "h": {
            ours: torch.stack([get(f"transformer.h.{i}.{theirs}")
                               for i in range(cfg.n_layer)])
            for ours, theirs in _HF_LAYER_NAMES.items()
        },
        "lnf_g": get("transformer.ln_f.weight").clone(),
        "lnf_b": get("transformer.ln_f.bias").clone(),
    }


def export_hf_gpt2(params: Dict, cfg: GPT2Config, prefix: str = "") -> Dict:
    """Inverse of :func:`import_hf_gpt2` (plus the weight-tied
    ``lm_head``)."""
    out = {
        prefix + "transformer.wte.weight": params["wte"].detach().cpu().clone(),
        prefix + "transformer.wpe.weight": params["wpe"].detach().cpu().clone(),
        prefix + "lm_head.weight": params["wte"].detach().cpu().clone(),
    }
    for ours, theirs in _HF_LAYER_NAMES.items():
        for i in range(cfg.n_layer):
            out[f"{prefix}transformer.h.{i}.{theirs}"] = (
                params["h"][ours][i].detach().cpu().clone())
    out[prefix + "transformer.ln_f.weight"] = params["lnf_g"].detach().cpu().clone()
    out[prefix + "transformer.ln_f.bias"] = params["lnf_b"].detach().cpu().clone()
    return out
