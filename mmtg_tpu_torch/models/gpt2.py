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
PyTorch attention — the JAX package runs XLA attention there too). The
train path's remat keeps what the JAX package's selective policies keep
(:data:`REMAT_POLICIES`, :class:`_RematBlock`). Tensor parallelism
(``tp_group``: this rank holds its heads' QKV / MLP columns and the
matching rows of the two output projections,
:mod:`mmtg_tpu_torch.parallel.mesh`, and the row-parallel
partial products are summed over the group before their replicated bias) in
training, the prefill and the decode step; in training the sums are Megatron's
two conjugate operators (:func:`copy_to_tp`, :func:`reduce_from_tp`), so the
backward sums the input gradients of the column-parallel products; in the
prefill and the decode step an ordered fold in one device's order
(:func:`tp_sum`, :func:`tp_products`), so a mesh gives one card's tokens. GPipe
pipeline parallelism of the train path (``pp``,
:mod:`mmtg_tpu_torch.parallel.pipeline`). The one-token decode
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
import torch.distributed as dist

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
from mmtg_tpu_torch.ops.layer_norm import add_layer_norm_plain, add_layer_norm_rows
from mmtg_tpu_torch.ops.layer_norm import layer_norm_plain as layer_norm
from mmtg_tpu_torch.ops.layer_norm import layer_norm_rows
from mmtg_tpu_torch.ops.matmul import batched_matmul, matmul, matmul_plain
from mmtg_tpu_torch.parallel.mesh import all_reduce_, broadcast_, recv, send
from mmtg_tpu_torch.ops.train_attention import (
    attention_keep,
    attention_replay,
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
    "layer_norm", "gelu_new", "REMAT_POLICIES", "gpt2_forward", "init_cache",
    "merge_kv", "prefill_cache", "gpt2_decode_step", "import_hf_gpt2",
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


def tp_sum(x: torch.Tensor, w: torch.Tensor, group, mm=matmul_plain,
           bias=None) -> torch.Tensor:
    """The row-parallel product ``x @ w (+ bias)`` of this rank's K slice
    (``x [..., K/tp]``, ``w [K/tp, N]``) summed over the ``model`` group in
    the one device's order, on every rank (``group=None``: ``mm(x, w,
    bias)``). An ordered fold, not an ``all_reduce``: rank 0 computes its
    ranges' f32 partial (``mm``'s ``partial_out``), each next rank receives
    its predecessor's and continues the fold from it (``acc_in``), the last
    rank rounds once (and adds ``bias``) and broadcasts the product, so the
    sums are those of ``mm`` on the whole weight (:func:`mmtg_tpu_torch.ops.
    matmul.shard_plan`) whatever tp. ``tp_sum.calls`` counts the products."""
    if group is None:
        return mm(x, w, bias)
    tp_sum.calls += 1
    ranks = dist.get_process_group_ranks(group)
    i = dist.get_rank(group)
    shape = (*x.shape[:-1], w.shape[-1])
    acc = (None if i == 0 else
           recv(shape, torch.float32, x.device, ranks[i - 1], group))
    last = i == len(ranks) - 1
    y = mm(x, w, bias if last else None, acc_in=acc, partial_out=not last,
           plan_shape=(w.shape[-2] * len(ranks), w.shape[-1]))
    if not last:
        send(y, ranks[i + 1], group)
        y = torch.empty(shape, dtype=x.dtype, device=x.device)
    return broadcast_(y, ranks[-1], group)


tp_sum.calls = 0


def tp_products(mm, group):
    """(column-parallel, row-parallel) forms of the product ``mm(x, w,
    bias)`` on this rank's shard: the column shards run the full weight's
    plan (``plan_shape``), the row shards fold through :func:`tp_sum`.
    ``group=None``: ``(mm, mm)``."""
    if group is None:
        return mm, mm
    tp = dist.get_world_size(group)

    def column(x, w, bias=None):
        return mm(x, w, bias, plan_shape=(w.shape[-2], w.shape[-1] * tp))

    def row(x, w, bias=None):
        return tp_sum(x, w, group, mm, bias)

    return column, row


class _CopyToTP(torch.autograd.Function):
    """Identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f`` at the input of a column-parallel product: ``x`` as
    it is, and in the backward its gradient summed over the ``model`` group
    (each rank's product saw only its columns). ``group=None``: identity."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g`` at the output of a row-parallel product: the partial
    products summed over the ``model`` group, the gradient passed through
    as it is. ``group=None``: identity."""
    return x if group is None else _ReduceFromTP.apply(x, group)


_M32 = 0xFFFFFFFF
TP_SALT, MICRO_SALT, DATA_SALT = 0x6A09E667, 0xBB67AE85, 0x3C6EF372


def _fmix32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def fold_seed(seed: int, k: int, salt: int) -> int:
    """A 31-bit seed from ``seed`` and an index ``k`` (a TP rank, a
    micro-batch, a data rank; ``salt`` tells which): murmur3's finaliser,
    a bijection, over the seed mixed with the salt, then over that plus an
    odd multiple of ``k + 1``, so every ``k`` gives another 32-bit value."""
    x = _fmix32((int(seed) * 0x9E3779B1 + salt) & _M32)
    return _fmix32((x + (int(k) + 1) * 0x27D4EB2F) & _M32) & 0x7FFFFFFF


class DropoutSeeds(NamedTuple):
    """The seeds of one forward's dropout masks, drawn before the layer
    loop: the embedding's, each layer's two residual ones and its attention
    one."""

    embd: int
    resid: list  # [(k_resid1, k_resid2)] a layer
    attn: list  # [int] a layer

    def fold(self, k: int, salt: int, attn_only: bool = False) -> "DropoutSeeds":
        f = lambda x: fold_seed(x, k, salt)  # noqa: E731
        resid = self.resid if attn_only else [(f(a), f(b)) for a, b in self.resid]
        return DropoutSeeds(self.embd, resid, [f(a) for a in self.attn])


def dropout_seeds(gen: torch.Generator, n_layer: int,
                  tp_index: Optional[int] = None) -> DropoutSeeds:
    """``1 + 3L`` draws from ``gen``. Under tensor parallelism the attention
    seeds are folded with the rank's ``model`` index (the kernels' hash
    numbers heads locally, so each rank's heads get masks of their own),
    while the embedding and residual seeds stay the same on every rank of
    the group: those masks drop elements of the replicated residual stream,
    which must stay identical across the group (Megatron's rule)."""
    draws = torch.randint(0, 2 ** 31 - 1, (1 + 3 * n_layer,), generator=gen,
                          device=gen.device).cpu().tolist()
    seeds = DropoutSeeds(draws[0], [(draws[2 + 3 * l], draws[3 + 3 * l])
                                    for l in range(n_layer)],
                         draws[1::3][:n_layer])
    return seeds if tp_index is None else seeds.fold(tp_index, TP_SALT,
                                                     attn_only=True)


# The selective remat menu of the train forward (:mod:`mmtg_tpu.models.gpt2`'s
# ``_REMAT_POLICIES``): the named tensors a block keeps for its backward
# beside its input. "qkv" is the c_attn product, "attn_ctx" the attention's
# context, "mlp_fc1" the c_fc product plus its bias, before gelu_new. The
# rest of the block (LayerNorms, dropout, residuals, the other products,
# gelu_new) is recomputed in the backward; so is a named tensor not kept.
REMAT_POLICIES = {
    "full": (),  # the block input only (lowest memory)
    "save_qkv_ctx": ("qkv", "attn_ctx"),
    "save_ctx_fc1": ("attn_ctx", "mlp_fc1"),  # the attention runs once
    "save_all": ("qkv", "attn_ctx", "mlp_fc1"),
}


class _KeptProduct(torch.autograd.Function):
    """``x @ w (+ b)`` whose value ``y`` the forward kept: ``y`` without the
    product, differentiated as the product is."""

    @staticmethod
    def forward(ctx, y, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bias = b is not None
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        g2 = g.reshape(-1, g.shape[-1])
        dx = g @ w.T if need[1] else None
        dw = x.reshape(-1, x.shape[-1]).T @ g2 if need[2] else None
        db = g2.sum(0) if ctx.bias and need[3] else None
        return None, dx, dw, db


class _Tape:
    """The named tensors of one block (the JAX package's ``checkpoint_name``
    sites), those in ``names`` kept: a forward (``kept=None``) computes every
    site and stores the kept ones in ``self.kept``; a replay takes them from
    ``kept`` and computes the rest. ``names=()``: every site as it is."""

    def __init__(self, names=(), kept=None):
        self.names, self.replay = names, kept is not None
        self.kept = kept if kept is not None else {}

    def product(self, name, x, w, b=None):
        if self.replay and name in self.names:
            return _KeptProduct.apply(self.kept[name], x, w, b)
        y = x @ w if b is None else x @ w + b
        if name in self.names:
            self.kept[name] = y
        return y

    def attention(self, attend, qkv, *args):
        if "attn_ctx" not in self.names:
            return attend(qkv, *args)
        if self.replay:
            return attention_replay(attend, self.kept["attn_ctx"], qkv, *args)
        ctx, self.kept["attn_ctx"] = attention_keep(attend, qkv, *args)
        return ctx


_NO_TAPE = _Tape()


class _RematBlock(torch.autograd.Function):
    """One block that keeps its input and its ``names`` tensors and, in the
    backward, runs again with the kept tensors in place
    (:class:`_KeptProduct`, :func:`~mmtg_tpu_torch.ops.train_attention.
    attention_replay`): what is kept is neither recomputed nor launched
    again. ``run(h, tensors, tape)`` is the block, a pure function of its
    arguments (dropout masks from seeds), so the replay recomputes the same
    values, the tensor-parallel sums in the same order on every rank."""

    @staticmethod
    def forward(ctx, run, names, h, *tensors):
        tape = _Tape(names)
        out = run(h, tensors, tape)
        ctx.run, ctx.names, ctx.kept = run, names, tape.kept
        ctx.save_for_backward(h, *tensors)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, want)]
            out = ctx.run(inputs[0], inputs[1:], _Tape(ctx.names, ctx.kept))
            ctx.kept = None
            grads = iter(torch.autograd.grad(
                out, [t for t, w in zip(inputs, want) if w], g))
        return (None, None) + tuple(next(grads) if w else None for w in want)


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
    tp_group=None,
    pp: Optional[Tuple] = None,
    remat_policy: str = "full",
    use_kernels: bool = False,
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
      remat: recompute each block in the backward instead of keeping its
        activations, all but what ``remat_policy`` keeps.
      remat_policy: one of :data:`REMAT_POLICIES` (``"full"``: the block
        input only; ``"save_qkv_ctx"``, ``"save_ctx_fc1"``, ``"save_all"``:
        also the named tensors, which the backward neither recomputes nor,
        for the attention context, launches again; with the context a
        kernel also keeps its ``[B, H, T]`` f32 row log-sum-exp). Read only
        with ``remat`` and gradients on; the pipeline (``pp``) recomputes
        each stage from its input under any policy.
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
      use_kernels: the prefill's (``return_kv``) products (QKV, the
        attention's two, the projections, the MLP, the LM head) through the
        batch-invariant product and its LayerNorms through the
        batch-invariant LayerNorm (:mod:`mmtg_tpu_torch.ops.matmul`,
        :mod:`mmtg_tpu_torch.ops.layer_norm`; no gradient), else the torch
        ops. Prefill only: raises without ``return_kv``.
      lm_head: ``False`` returns the final hidden states ``[B, T, D]``
        (for the chunked loss) instead of logits.
      segment_ids: ``[B, T]`` ids of packed rows
        (:mod:`mmtg_tpu_torch.pack`): attention is causal within equal ids
        and blocked across them; replaces ``attention_mask``. Train path
        only (raises with ``return_kv``). Both kernel values then run
        :func:`~mmtg_tpu_torch.ops.train_attention.mha_train_packed_seg`
        (only the standard slab takes segment ids, as in the JAX package),
        ``"plain"`` its plain version.
      tp_group: the ``model`` process group of a tensor-parallel forward:
        ``params`` are this rank's shard (:func:`mmtg_tpu_torch.parallel.
        mesh.shard_params`), the head count and width come from its QKV
        columns, attention runs on its heads, and with ``return_kv`` the
        returned k/v hold its heads only. The train path sums through
        :func:`copy_to_tp` / :func:`reduce_from_tp` (differentiable; also
        under remat), the prefill through :func:`tp_sum`. Dropout follows
        :func:`dropout_seeds`.
      pp: ``(mesh, n_micro)``: the layer stack GPipe-pipelined over the
        ``pipe`` axis of a ``("data", "pipe")`` mesh
        (:func:`mmtg_tpu_torch.parallel.pipeline.pipeline_stack`);
        ``params["h"]`` holds this stage's layers. Each micro-batch's
        dropout seeds are folded with its index. Train path only (raises
        with ``return_kv`` or ``segment_ids``).
    Returns:
      (logits ``[B, T, V]`` or hidden, per-layer (k, v) each ``[L, B, T,
      D]`` when ``return_kv``).
    """
    if attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: one of {sorted(_ATTN_IMPLS)}")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}: one of "
                         f"{sorted(REMAT_POLICIES)}")
    attn_impl = _ATTN_IMPLS[attn_impl]
    if use_kernels and not return_kv:
        raise ValueError("gpt2_forward: use_kernels is prefill-only (return_kv); "
                         "the train path runs the torch ops (autograd)")
    # the prefill's products and LayerNorms (ops/matmul, ops/layer_norm: a
    # row's bits do not depend on the batch, where cuBLAS and PyTorch's
    # reductions lay a row out by the shape)
    prefill_mm = matmul if use_kernels else matmul_plain
    col_mm, row_mm = tp_products(prefill_mm, tp_group if return_kv else None)
    prefill_bmm = batched_matmul if use_kernels else torch.matmul
    ln = layer_norm_rows if use_kernels else layer_norm
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
    if pp is not None and (return_kv or segment_ids is not None):
        raise ValueError("pipeline parallelism is train-path only (return_kv "
                         "and segment_ids unsupported)")
    if pp is not None and tp_group is not None:
        raise ValueError("gpt2_forward: pp and tp_group are exclusive")
    seeds = None
    if dropout:
        tp_index = dist.get_rank(tp_group) if tp_group is not None else None
        seeds = dropout_seeds(dropout_gen, L, tp_index)
        h = _dropout(h, cfg.embd_pdrop, seeds.embd)
    attn_rate = cfg.attn_pdrop if dropout else 0.0

    hd = cfg.head_dim
    # local (under TP: this shard's) width and head count, from the QKV columns
    D_kv = params["h"]["attn_w"].shape[-1] // 3
    n_head = D_kv // hd
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
        T = Tp

    p = params["h"]
    eps = cfg.layer_norm_epsilon

    def attn_seed_tensor(attn):
        """The attention seeds ``[n]`` on the device (zeros: no dropout)."""
        if attn is None:
            return torch.zeros(L, dtype=torch.int32, device=h.device)
        return torch.tensor(attn, dtype=torch.int32, device=h.device)

    def layer(h, lp, resid, attn_seed, bias, tape=_NO_TAPE):
        """One block on ``h`` ``[b, T, D]``: ``lp`` the layer's parameters,
        ``resid`` its two residual seeds, ``attn_seed`` ``[1]`` int32,
        ``tape`` its named tensors (:class:`_Tape`; train path)."""
        k_resid1, k_resid2 = resid
        a = ln(h, lp["ln1_g"], lp["ln1_b"], eps)
        k = v = None
        w_proj = lp["attn_proj_w"]
        b = h.shape[0]
        if return_kv:
            q, k, v = col_mm(a, lp["attn_w"], lp["attn_b"]).split(D_kv, dim=-1)
            qh, kh, vh = (t.view(b, T, n_head, hd).transpose(1, 2)
                          for t in (q, k, v))
            # f32-accumulated score dot, then the model dtype (as the JAX
            # einsum with preferred_element_type=f32)
            scores = prefill_bmm(qh.float(), kh.float().transpose(-1, -2))
            probs = torch.softmax(scores.to(h.dtype) * scale + bias, dim=-1)
            ctx = prefill_bmm(probs, vh).transpose(1, 2).reshape(b, T, D_kv)
            attn_out = row_mm(ctx, w_proj)
        else:
            # the projection bias is added inside the attention function
            w_qkv, b_qkv = lp["attn_w"], lp["attn_b"]
            if attn_impl == "kernel_padded":
                w_qkv, b_qkv = pad_qkv_weights(w_qkv, b_qkv, n_head, hd)
                w_proj = pad_proj_weights(w_proj, n_head, hd)
            qkv = tape.product("qkv", copy_to_tp(a, tp_group), w_qkv)
            ctx = tape.attention(attend, qkv, b_qkv, bias, attn_seed, n_head,
                                 attn_rate, 1.0 / math.sqrt(hd))
            attn_out = reduce_from_tp(ctx @ w_proj, tp_group)
        h = h + _dropout(attn_out + lp["attn_proj_b"], cfg.resid_pdrop, k_resid1)
        m = ln(h, lp["ln2_g"], lp["ln2_b"], eps)
        if not return_kv:
            m = copy_to_tp(m, tp_group)
        if return_kv:
            m = gelu_new(col_mm(m, lp["mlp_fc_w"], lp["mlp_fc_b"]))
            m = row_mm(m, lp["mlp_proj_w"])
        else:
            m = gelu_new(tape.product("mlp_fc1", m, lp["mlp_fc_w"], lp["mlp_fc_b"]))
            m = reduce_from_tp(m @ lp["mlp_proj_w"], tp_group)
        return h + _dropout(m + lp["mlp_proj_b"], cfg.resid_pdrop, k_resid2), k, v

    no_resid = (None, None)
    ks, vs = [], []
    if pp is not None:
        from mmtg_tpu_torch.parallel.pipeline import pipeline_stack

        pp_mesh, n_micro = pp
        Lp = next(iter(p.values())).shape[0]
        first = pp_mesh.get_local_rank(1) * Lp

        def run_stage(x, sp, aux, m):
            """This stage's layers on micro-batch ``m`` (its seeds folded
            with ``m``)."""
            s = seeds.fold(m, MICRO_SALT) if seeds is not None else None
            attn = attn_seed_tensor(s.attn if s is not None else None)
            for j in range(Lp):
                l = first + j
                x, _, _ = layer(x, {k: v[j] for k, v in sp.items()},
                                s.resid[l] if s is not None else no_resid,
                                attn[l:l + 1], aux[0])
            return x

        h = pipeline_stack(run_stage, p, h, [bias], pp_mesh, n_micro)
    else:
        attn = (attn_seed_tensor(seeds.attn if seeds is not None else None)
                if not return_kv else None)
        for l in range(L):
            lp = {k: v[l] for k, v in p.items()}
            args = (h, lp, seeds.resid[l] if seeds is not None else no_resid,
                    attn[l:l + 1] if attn is not None else None, bias)
            if remat and torch.is_grad_enabled():
                # masks are functions of their seeds, so the replay draws
                # them again without any generator state
                h = _remat_block(layer, REMAT_POLICIES[remat_policy], *args)
                k = v = None
            else:
                h, k, v = layer(*args)
            if return_kv:
                ks.append(k)
                vs.append(v)
    if T != T_real:
        h = h[:, :T_real]
    h = ln(h, params["lnf_g"], params["lnf_b"], eps)
    kv = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    if not lm_head:
        return h, kv
    return prefill_mm(h, params["wte"].T), kv


def _remat_block(layer, names, h, lp, resid, attn_seed, bias):
    """``layer(h, lp, resid, attn_seed, bias, tape)`` under
    :class:`_RematBlock`, keeping the tensors ``names``."""
    keys = list(lp)

    def run(h, tensors, tape):
        *w, attn_seed, bias = tensors
        return layer(h, dict(zip(keys, w)), resid, attn_seed, bias, tape)[0]

    return _RematBlock.apply(run, names, h, *lp.values(), attn_seed, bias)


def prefill_cache(
    params: Dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    token_type_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    capacity: int,
    cache_dtype: str = "model",
    tp_group=None,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt once; return its logits and a cache of ``capacity``
    slots holding the prompt's k/v (``cache_dtype`` ``"model"``, ``"int8"``
    or ``"int4"``). Under ``tp_group`` the cache holds this shard's heads
    (a quantized one scaled over them alone, as in the JAX package).
    ``use_kernels=False``: the torch ops for the products and LayerNorms
    that otherwise take the batch-invariant kernels (a reference for the
    kernel path)."""
    if cache_dtype not in _CACHE_KINDS:
        raise ValueError(f"unknown cache kind {cache_dtype!r}")
    logits, (k, v) = gpt2_forward(params, cfg, inputs_embeds, position_ids,
                                  token_type_ids, attention_mask,
                                  return_kv=True, tp_group=tp_group,
                                  use_kernels=use_kernels)
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


def _mm(x, p, l, key, mm=matmul_plain, bias=None):
    """``mm(x, W) (+ bias)`` for layer ``l`` (``mm``: ``torch.matmul`` or the
    batch-invariant kernel, which adds the bias in its epilogue with the same
    two roundings, or their tensor-parallel forms, :func:`tp_products`);
    weight-only int8 (``key_q`` / ``key_s`` from
    :func:`quantize_decode_weights`) dequantizes in the matmul's epilogue,
    in f32, then casts back to x's dtype, before the bias (under TP after the
    fold, as on one device)."""
    if key + "_q" in p:
        y = (mm(x, p[key + "_q"][l].to(x.dtype)) * p[key + "_s"][l]).to(x.dtype)
        return y if bias is None else y + bias
    return mm(x, p[key][l], bias)


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
    tp_group=None,
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
    reference for the kernel path). ``tp_group``: a tensor-parallel step on
    this rank's shard (:func:`gpt2_forward`); the cache holds its heads, the
    per-layer kernels attend over them, and the logits are the whole
    vocabulary's on every rank (the LM head is replicated).
    """
    if attn_impl not in ("kernel", "fused"):
        raise ValueError(f"attn_impl {attn_impl!r}: 'kernel' or 'fused'")
    p = params["h"]
    # local (under TP: this shard's) width and head count, from the QKV columns
    D_kv = p["attn_w"].shape[-1] // 3
    n_head = D_kv // cfg.head_dim
    kind = cache.kind(D_kv)
    h = x_embed + params["wpe"][position] + params["wte"][token_type_id]
    if attn_impl == "fused":
        if kind != "int8" or cache.merged or "attn_w_q" in p or tp_group is not None:
            raise ValueError("attn_impl='fused' needs an int8 split cache, "
                             "full-precision weights and no tensor parallelism")
        block = decode_block_fused if use_kernels else decode_block_fused_plain
        h = block(h.contiguous(), p, cache.k, cache.v, cache.k_scale,
                  cache.v_scale, key_mask, position, n_head=n_head,
                  eps=cfg.layer_norm_epsilon)
        pending = None
    else:
        h, pending = _decode_layers(p, cfg, cache, h, position, key_mask, use_kernels,
                                    kind, n_head, tp_group)
    # the final LayerNorm (with the last MLP residual still to add) and the LM
    # head through the batch-invariant kernels (ops/layer_norm, ops/matmul):
    # PyTorch's reduction and cuBLAS lay a row out by B
    h = _residual_ln(h, pending, params["lnf_g"], params["lnf_b"], cfg, use_kernels)[1]
    mm = matmul if use_kernels else matmul_plain
    if "wte_q" in params:
        return (mm(h, params["wte_q"].to(h.dtype).T) * params["wte_s"].T).to(h.dtype)
    return mm(h, params["wte"].T)


def _residual_ln(h, pending, g, b, cfg, use_kernels):
    """``(h, LayerNorm(h))``; with ``pending`` = (y, bias) the residual
    ``h_new = h + y + bias`` and its LayerNorm in one launch → ``(h_new,
    LayerNorm(h_new))``."""
    eps = cfg.layer_norm_epsilon
    if pending is None:
        return h, (layer_norm_rows if use_kernels else layer_norm)(h, g, b, eps)
    add_ln = add_layer_norm_rows if use_kernels else add_layer_norm_plain
    return add_ln(h, *pending, g, b, eps)


def _decode_layers(p, cfg, cache, h, position, key_mask, use_kernels, kind,
                   n_head, tp_group=None):
    """The per-layer decode loop: one append + attention call a layer; with
    ``use_kernels`` its LayerNorms and products run the batch-invariant
    kernels. A residual ``h + y + bias`` is added inside the LayerNorm that
    follows it (ops/layer_norm.add_layer_norm_rows: one launch for the two
    adds and the norm); the last layer's MLP residual is returned pending →
    ``(h, (y, bias))`` for the final LayerNorm."""
    col_mm, row_mm = tp_products(matmul if use_kernels else matmul_plain, tp_group)
    D_kv = p["attn_w"].shape[-1] // 3
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
    pending = None  # the previous layer's MLP residual (y, bias)
    for l in range(cfg.n_layer):
        h, a = _residual_ln(h, pending, p["ln1_g"][l], p["ln1_b"][l], cfg, use_kernels)
        q, k, v = _mm(a, p, l, "attn_w", col_mm, p["attn_b"][l]).split(D_kv, dim=-1)
        ctx = attend(q.contiguous(), k.contiguous(), v.contiguous(),
                     key_mask=key_mask, position=position, layer=l,
                     n_head=n_head)
        y = _mm(ctx, p, l, "attn_proj_w", row_mm)
        h, m = _residual_ln(h, (y, p["attn_proj_b"][l]), p["ln2_g"][l], p["ln2_b"][l],
                            cfg, use_kernels)
        m = gelu_new(_mm(m, p, l, "mlp_fc_w", col_mm, p["mlp_fc_b"][l]))
        pending = (_mm(m, p, l, "mlp_proj_w", row_mm), p["mlp_proj_b"][l])
    return h, pending


def quantize_decode_weights(params: Dict, scale_group=None) -> Dict:
    """Weight-only int8 for the decode loop
    (:func:`mmtg_tpu.models.gpt2.quantize_decode_weights`): per-output-
    channel abs-max over the four glue matmuls (``[L, in, out]`` → scales
    ``[L, 1, out]``) and per-vocab-row over ``wte`` (scales ``[V, 1]``).
    The full-precision weights stay in the returned dict.

    ``scale_group``: the ``model`` group of a tensor-parallel shard. The
    row-parallel projections hold only their input rows there, so their
    abs-max is taken over the group (``all_reduce`` MAX) and the scales are
    the unsharded ones; column shards hold whole output channels already."""
    out = dict(params)
    h = dict(params["h"])

    def q(w, dim, group=None):
        w = w.float()
        absmax = w.abs().amax(dim=dim, keepdim=True)
        if group is not None:
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        s = true_div(absmax.clamp_min(1e-8), 127.0)
        return torch.round(w / s).clamp(-127, 127).to(torch.int8), s

    for key in ("attn_w", "attn_proj_w", "mlp_fc_w", "mlp_proj_w"):
        row_parallel = key in ("attn_proj_w", "mlp_proj_w")
        h[key + "_q"], h[key + "_s"] = q(h[key], 1,
                                         scale_group if row_parallel else None)
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
