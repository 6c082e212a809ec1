"""Batched KV-cached generation (:mod:`mmtg_tpu.decoding`).

The encoder and the topic-prompt prefill run once per call; then a Python
loop of ``gcfg.length`` (220) steps forces frame tokens, samples (repetition
penalty, bans, top-k / top-p), embeds the token with its WenLan vector plus
the fused experience window, and runs one cached GPT-2 step. For CUDA
tensors that step attends through the hand-written decode-attention kernel
(full-precision, int8, int4 or merged k‖v cache) or, with
``attn_impl="fused"``, runs all its layers in the whole-step kernel, and the
encoder runs the fused GRU kernel; for CPU tensors each is its plain PyTorch
version. That is the only switch.

:func:`generate` returns the whole batch at once; :func:`generate_stream`
yields it in blocks of ``chunk`` steps. Both drive one step function keyed on
the GLOBAL step index, so any chunking equals the one-shot loop bit for bit.

Random draws come from a ``torch.Generator`` (one stream for the batch) or,
given a threefry key of :mod:`mmtg_tpu_torch.ops.prng`, from JAX's own
counter-based streams: ``fold_in(rng, step)`` for the batch, or with
``row_seeds`` ``fold_in(fold_in(rng, row_seeds[b]), step)`` per row — a row's
tokens then depend on nothing batch-shaped, which is what lets the serving
layer (:mod:`mmtg_tpu_torch.serve`) re-batch requests freely.

Same frame / PAD / penalty / mask / type-id semantics as the JAX engine.
``topk_impl="approx"`` takes the exact top-k (what ``lax.approx_max_k``
computes off the TPU). Without a counterpart here: the TPU layout work
(sublane padding of the batch, ``layer_unroll``, ``score_dtype``, the Mosaic
``% 128`` lane gate of ``resolve_attn_impl``) and the B = 1 switch to XLA
attention.

Spans (:func:`mmtg_tpu_torch.utils.logging.span`): ``decode.call`` over a
call (the streaming forms: over the set-up and over each block),
``decode.setup`` over the encoder, the prefill and the decode weights'
preparation, and one ``decode.step`` a step holding ``decode.sample``
(sampled steps only: none on a frame-forced step), ``decode.embed`` and
``decode.model``.

:func:`generate_sharded` / :func:`generate_stream_sharded` decode over a
``(data, model)`` process mesh (:mod:`mmtg_tpu_torch.parallel.mesh`): every
rank is called with the global batch, decodes its data shard's rows —
tensor-parallel over the ``model`` group, through the same per-layer kernels
at the shard's head count — and returns the global tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import torch

from mmtg_tpu_torch.configs import DataConfig, GenerateConfig, ModelConfig, SpecialTokens
from mmtg_tpu_torch.models.gpt2 import (
    KVCache,
    gpt2_decode_step,
    merge_kv,
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
from mmtg_tpu_torch.ops import prng
from mmtg_tpu_torch.ops.sampling import frame_forced_token, sample_next_token
from mmtg_tpu_torch.parallel import mesh as pmesh
from mmtg_tpu_torch.utils.logging import span

SPECIAL = SpecialTokens()
_CACHE_DTYPES = ("model", "int8", "int4")
_ATTN_IMPLS = ("auto", "kernel", "pallas", "xla", "fused")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_weight_dtype(gcfg: GenerateConfig, batch_size: int) -> str:
    """``'auto'`` → weight-only int8 at B ≤ 32, else the model dtype. The
    threshold is the JAX package's, kept for parity until it is measured
    on the H100."""
    if gcfg.weight_dtype != "auto":
        return gcfg.weight_dtype
    return "int8" if batch_size <= 32 else "model"


def resolve_cache_dtype(gcfg: GenerateConfig, batch_size: int,
                        sharded: bool = False) -> str:
    """``'auto'`` → int8 KV cache at B ≥ 2, the model dtype at B = 1 (the
    JAX package's threshold, kept for parity until measured on the H100),
    and the model dtype in every meshed run (``sharded``): under tensor
    parallelism an int8 cache's row scales are taken over the shard's heads
    alone, so its tokens would depend on the mesh's shape, and ``auto`` must
    not depend on it (DP-only meshes included, as in the JAX package; an
    explicit ``"int8"`` stays available). Like ``weight_dtype='auto'`` the
    resolution changes the sampling numerics with the batch size, so callers
    that promise one answer per (request, seed) pin it once:
    ``serve.GenerationService`` from its largest bucket, the generate CLI
    from the nominal ``--batch_size``, the sharded calls from the global
    batch."""
    if gcfg.cache_dtype != "auto":
        return gcfg.cache_dtype
    if sharded:
        return "model"
    return "model" if batch_size <= 1 else "int8"


def resolve_attn_impl(gcfg: GenerateConfig, d_kv: int,
                      tp_axis: Optional[str] = None,
                      batch_size: Optional[int] = None) -> str:
    """The EFFECTIVE decode implementation: ``"fused"`` (the whole-step
    kernel) or ``"kernel"`` (the per-layer loop, which ``kernel`` /
    ``auto`` / ``pallas`` / ``xla`` all mean here). ``fused`` holds only
    inside its scope — int8 split cache (``merged_kv`` off), full-precision weights, ``d_kv`` a
    multiple of 8 for the kernel's 16-byte weight loads, no tensor
    parallelism (``tp_axis``) — and resolves to the per-layer kernels
    elsewhere, as in the JAX package. ``'auto'`` cache / weights resolve per
    batch; without a batch (config-only reporting) the large-batch
    resolutions (int8 / model; the model dtype under TP) are assumed. Of
    the JAX gates, the Mosaic ``% 128`` lane rule, the sublane rule and the
    B = 1 switch to XLA attention are the TPU's and have no counterpart."""
    if gcfg.attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"attn_impl {gcfg.attn_impl!r}: one of {_ATTN_IMPLS}")
    if gcfg.attn_impl != "fused":
        return "kernel"
    sharded = tp_axis is not None
    if batch_size is not None:
        cd = resolve_cache_dtype(gcfg, batch_size, sharded)
        wd = resolve_weight_dtype(gcfg, batch_size)
    elif gcfg.cache_dtype == "auto":
        cd = "model" if sharded else "int8"
        wd = "model" if gcfg.weight_dtype == "auto" else gcfg.weight_dtype
    else:
        cd = gcfg.cache_dtype
        wd = "model" if gcfg.weight_dtype == "auto" else gcfg.weight_dtype
    in_scope = (cd == "int8" and not gcfg.merged_kv and wd != "int8"
                and d_kv % 8 == 0 and not sharded)
    return "fused" if in_scope else "kernel"


def _resolved(gcfg: GenerateConfig, batch_size: int):
    """``gcfg`` with its cache dtype pinned, and the effective (attn_impl,
    weight dtype) for this batch."""
    gcfg = dataclasses.replace(
        gcfg, cache_dtype=resolve_cache_dtype(gcfg, batch_size))
    if gcfg.cache_dtype not in _CACHE_DTYPES:
        raise ValueError(f"cache_dtype {gcfg.cache_dtype!r}: one of "
                         f"{_CACHE_DTYPES} or 'auto'")
    return gcfg, resolve_weight_dtype(gcfg, batch_size)


def _scheme(gcfg: GenerateConfig):
    return (infer_scheme_type_ids if gcfg.type_id_scheme == "reference_infer"
            else train_scheme_type_ids)


def _prefill(params, table, mcfg, dcfg, gcfg, batch, fused, first_tok,
             capacity, attn_impl, tp_group=None, use_kernels=True):
    """Topic prompt + first target token through the prefill; returns
    (last-position logits, cache, key_mask). ``gcfg.cache_dtype`` is
    resolved. With ``merged_kv`` the int8 cache of the per-layer path is
    packed into one k‖v buffer here, once per call (not under TP, as in the
    JAX package)."""
    B = first_tok.shape[0]
    P = dcfg.topic_prompt_length
    dev = first_tok.device
    embeds = decoder_input_embeds(params, table, dcfg, fused,
                                  batch["topic_ids"], first_tok[:, None],
                                  use_kernels=use_kernels)
    type_ids = torch.cat([batch["tpw_type_ids"].to(torch.int64),
                          torch.zeros(B, 1, dtype=torch.int64, device=dev)], 1)
    attn_mask = torch.cat([batch["tpw_attention_mask"].to(torch.int32),
                           torch.ones(B, 1, dtype=torch.int32, device=dev)], 1)
    logits, cache = prefill_cache(
        params["gpt2"], mcfg.gpt2, embeds, torch.arange(P + 1, device=dev),
        type_ids, attn_mask, capacity, gcfg.cache_dtype, tp_group=tp_group,
        use_kernels=use_kernels)
    if (gcfg.merged_kv and gcfg.cache_dtype == "int8" and attn_impl == "kernel"
            and tp_group is None):
        cache = merge_kv(cache)
    key_mask = torch.zeros(B, capacity, dtype=torch.int32, device=dev)
    key_mask[:, :P + 1] = attn_mask
    return logits[:, -1], cache, key_mask


def _step_embed(params, table, dcfg, fused, gcfg, tok, j, use_kernels=True):
    """Embedding and type id of target token ``tok`` at target position
    ``j``: WenLan vector + its fused window (none past the last one)."""
    wl = wenlan_embed(table, tok)
    T_steps = fused.shape[1]
    if j < dcfg.two_sents_length * T_steps:
        wl = wl + fused[:, min(j // dcfg.two_sents_length, T_steps - 1)]
    x = project_to_gpt2(params, wl, use_kernels)
    pos = torch.full_like(tok, j)
    return x, _scheme(gcfg)(pos, tok, dcfg).to(torch.int64)


def _row_keys(rng: torch.Tensor, row_seeds: Optional[torch.Tensor]):
    """Per-row streams: key(b, i) = fold_in(fold_in(rng, row_seeds[b]), i)
    depends on nothing batch-shaped, so a row's sample path does not change
    with the rows it is batched with."""
    if row_seeds is None:
        return None
    return prng.fold_in(rng, row_seeds.to(rng.device))


@dataclasses.dataclass
class _DecodeState:
    """What the decode loop carries from step to step (updated in place)."""

    cache: KVCache
    key_mask: torch.Tensor
    tokens: torch.Tensor  # [B, 1 + length] int32, position 0 = [#START#]
    seen: torch.Tensor  # [B, V] int16 occurrence counts
    last_logits: torch.Tensor


def _step_keys(generator, row_seeds, B: int, length: int, dev):
    """The draw source of every step. A ``torch.Generator`` / ``None`` is
    passed through (one stream, consumed in step order). A threefry key
    gives ``[length, 2]`` keys ``fold_in(rng, i)`` or, with ``row_seeds``,
    ``[B, length, 2]`` keys ``fold_in(row_key_b, i)``: every step's key is a
    function of the GLOBAL step index, made here once for all steps."""
    if not isinstance(generator, torch.Tensor):
        if row_seeds is not None:
            raise ValueError(
                "row_seeds needs a threefry key as `generator` "
                "(mmtg_tpu_torch.ops.prng.PRNGKey(seed)): a torch.Generator "
                "is one stream for the whole batch")
        return generator
    rng = generator.to(dev)
    if rng.shape != (2,) or rng.dtype != torch.int64:
        raise ValueError(f"a threefry key is an int64 tensor [2], got "
                         f"{tuple(rng.shape)} {rng.dtype}")
    steps = torch.arange(length, dtype=torch.int64, device=dev)
    if row_seeds is None:
        return prng.fold_in(rng[None, :], steps)
    if row_seeds.shape != (B,) or row_seeds.dtype.is_floating_point:
        raise ValueError(f"row_seeds must be [B={B}] integers, got "
                         f"{tuple(row_seeds.shape)} {row_seeds.dtype}")
    return prng.fold_in(_row_keys(rng, row_seeds)[:, None, :], steps[None, :])


def _decode_setup(params, const, mcfg, dcfg, gcfg, batch, generator, row_seeds,
                  tp_group=None):
    """Encoder + prefill + decode-weight preparation: everything before the
    per-token loop, shared by :func:`generate`, :func:`generate_stream` and
    their sharded forms (``tp_group``: ``params`` are this rank's TP shard).
    Returns (state, step) where ``step(i)`` decodes GLOBAL step ``i`` (target
    position ``i + 1``) and updates ``state`` in place."""
    table = const["wenlan_table"]
    B = batch["topic_ids"].shape[0]
    dev = batch["topic_ids"].device
    V = mcfg.gpt2.vocab_size
    P = dcfg.topic_prompt_length
    d_kv = params["gpt2"]["h"]["attn_w"].shape[-1] // 3
    attn_impl = resolve_attn_impl(
        gcfg, d_kv, pmesh.MODEL_AXIS if tp_group is not None else None,
        batch_size=B)
    gcfg, weight_dtype = _resolved(gcfg, B)
    capacity = _round_up(P + gcfg.length + 1, 128)
    keys = _step_keys(generator, row_seeds, B, gcfg.length, dev)
    per_row = row_seeds is not None

    with span("decode.setup"):
        fused, _ = encode_experiences(params, mcfg, batch["topic_emb"],
                                      batch["img_embs"], batch["r_embs"],
                                      use_kernels=True)
        start = torch.full((B,), SPECIAL.start_id, dtype=torch.int64, device=dev)
        last_logits, cache, key_mask = _prefill(
            params, table, mcfg, dcfg, gcfg, batch, fused, start, capacity,
            attn_impl, tp_group)
        gpt2_params = params["gpt2"]
        if weight_dtype == "int8":
            gpt2_params = quantize_decode_weights(gpt2_params, scale_group=tp_group)

    tokens = torch.zeros(B, gcfg.length + 1, dtype=torch.int32, device=dev)
    tokens[:, 0] = SPECIAL.start_id
    # per-row occurrence counts (the penalty applies once per occurrence)
    seen = torch.zeros(B, V, dtype=torch.int16, device=dev)
    seen[:, SPECIAL.start_id] = 1
    state = _DecodeState(cache, key_mask, tokens, seen, last_logits)
    rows = torch.arange(B, device=dev)

    def step(i: int) -> None:
        with span("decode.step"):
            is_forced, forced_id = frame_forced_token(i, dcfg.sent_frame_length)
            if is_forced:
                tok = torch.full((B,), forced_id, dtype=torch.int64, device=dev)
            else:
                key = keys[..., i, :] if isinstance(keys, torch.Tensor) else keys
                with span("decode.sample"):
                    tok = sample_next_token(
                        key, state.last_logits, state.seen, state.tokens[:, i],
                        temperature=gcfg.temperature, top_k=gcfg.top_k,
                        top_p=gcfg.top_p,
                        repetition_penalty=gcfg.repetition_penalty,
                        topk_impl=gcfg.topk_impl, per_row_keys=per_row,
                    ).to(torch.int64)
            j = i + 1
            with span("decode.embed"):
                state.tokens[:, j] = tok.to(torch.int32)
                state.seen[rows, tok] += 1
                x, tt = _step_embed(params, table, dcfg, fused, gcfg, tok, j)
                state.key_mask[:, P + j] = (tok != SPECIAL.pad_id).to(torch.int32)
            with span("decode.model"):
                state.last_logits = gpt2_decode_step(
                    gpt2_params, mcfg.gpt2, state.cache, x, P + j, tt,
                    state.key_mask, attn_impl=attn_impl, tp_group=tp_group)

    return state, step


@torch.no_grad()
def generate(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    gcfg: GenerateConfig,
    batch: Dict[str, torch.Tensor],
    generator: Union[torch.Generator, torch.Tensor, None] = None,
    row_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generate lyrics for a whole batch.

    Args:
      batch: ``topic_ids``, ``tpw_attention_mask``, ``tpw_type_ids``
        ``[B, 15]``; ``topic_emb`` ``[B, 2048]``; ``img_embs`` / ``r_embs``
        ``[B, 5, 2048]`` — tensors on the device the params live on.
      generator: where the draws come from. A ``torch.Generator`` on that
        device (``None``: PyTorch's default generator), or a threefry key
        (``ops.prng.PRNGKey(seed)``, the JAX engine's ``rng``): step ``i``
        then draws from ``fold_in(rng, i)``, as the JAX engine does.
      row_seeds: optional ``[B]`` integers (needs a threefry key). Row ``b``
        then samples from its own stream, derived ONLY from ``(rng,
        row_seeds[b], step)``: its tokens are the same whichever rows share
        the batch.
    Returns:
      ``[B, 1 + length]`` int32 token ids, position 0 = ``[#START#]``.
    """
    with span("decode.call"):
        state, step = _decode_setup(params, const, mcfg, dcfg, gcfg, batch,
                                    generator, row_seeds)
        for i in range(gcfg.length):
            step(i)
    return state.tokens


def generate_stream(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    gcfg: GenerateConfig,
    batch: Dict[str, torch.Tensor],
    generator: Union[torch.Generator, torch.Tensor, None] = None,
    row_seeds: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
) -> Iterator[torch.Tensor]:
    """Streaming generation: yield ``[B, n]`` int32 token blocks as they are
    decoded, bit-identical to :func:`generate`.

    The encoder and the prefill run once, on the first ``next()``; then
    blocks of ``chunk`` steps (default ``dcfg.sent_frame_length`` = 22, one
    lyric sentence a block; ``n == chunk`` except possibly for the last).
    Concatenated, the blocks equal ``generate(...)[:, 1:]`` (the one-shot
    output without the seeded ``[#START#]`` column): both run the same step,
    keyed on the global step index. ``generator`` / ``row_seeds`` as in
    :func:`generate`. Each block is a fresh tensor on the batch's device;
    nothing waits for the device before the caller reads it."""
    chunk = dcfg.sent_frame_length if chunk is None else chunk
    chunk = max(1, min(int(chunk), gcfg.length))
    with torch.no_grad(), span("decode.call"):
        state, step = _decode_setup(params, const, mcfg, dcfg, gcfg, batch,
                                    generator, row_seeds)
    start = 0
    while start < gcfg.length:
        n = min(chunk, gcfg.length - start)
        with torch.no_grad(), span("decode.call"):  # not held across the yield
            for i in range(start, start + n):
                step(i)
            block = state.tokens[:, start + 1:start + n + 1].clone()
        yield block
        start += n


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
    tp_group=None,
) -> torch.Tensor:
    """Per-step logits of the cached decode engine under teacher forcing:
    ``tokens`` ``[B, K]`` (position 0 = ``[#START#]``) go through the same
    prefill + per-token cached step the sampler uses (the cache form and
    ``attn_impl`` of ``gcfg`` included; the weights stay full precision);
    returns ``[B, K, V]`` where row ``j`` predicts the token after
    ``tokens[:, :j+1]``.

    ``use_kernels=False`` runs the plain PyTorch versions of the kernels on
    any device — the reference the kernel path is held against.
    ``tp_group``: the step tensor-parallel over that ``model`` group, on
    this rank's shard of the params (``parallel.mesh.shard_decode_params``)
    — every rank of the group returns the whole vocabulary's logits."""
    table = const["wenlan_table"]
    B, K = tokens.shape
    P = dcfg.topic_prompt_length
    attn_impl = resolve_attn_impl(
        dataclasses.replace(gcfg, weight_dtype="model"),
        params["gpt2"]["h"]["attn_w"].shape[-1] // 3,
        pmesh.MODEL_AXIS if tp_group is not None else None, batch_size=B)
    gcfg, _ = _resolved(gcfg, B)
    capacity = _round_up(P + K + 1, 128)
    tokens = tokens.to(torch.int64)
    fused, _ = encode_experiences(params, mcfg, batch["topic_emb"],
                                  batch["img_embs"], batch["r_embs"],
                                  use_kernels=use_kernels)
    logits, cache, key_mask = _prefill(
        params, table, mcfg, dcfg, gcfg, batch, fused, tokens[:, 0], capacity,
        attn_impl, tp_group, use_kernels)
    out = [logits]
    for j in range(1, K):
        tok = tokens[:, j]
        x, tt = _step_embed(params, table, dcfg, fused, gcfg, tok, j, use_kernels)
        key_mask[:, P + j] = (tok != SPECIAL.pad_id).to(torch.int32)
        out.append(gpt2_decode_step(params["gpt2"], mcfg.gpt2, cache, x, P + j,
                                    tt, key_mask, use_kernels=use_kernels,
                                    attn_impl=attn_impl, tp_group=tp_group))
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Data x tensor-parallel decode over a process mesh
# ---------------------------------------------------------------------------


def _resolve_sharded_gcfg(gcfg: GenerateConfig, global_b: int) -> GenerateConfig:
    """Pin the batch-dependent ``auto`` resolutions from the GLOBAL batch: a
    data shard sees ``B / dp`` rows, and the tokens must not change with the
    mesh's shape. The cache resolves to the model dtype on every mesh
    (:func:`resolve_cache_dtype`); ``fused`` is gated per rank on the pinned
    cache and weights, and on tensor parallelism."""
    return dataclasses.replace(
        gcfg, cache_dtype=resolve_cache_dtype(gcfg, global_b, sharded=True),
        weight_dtype=resolve_weight_dtype(gcfg, global_b))


def _shard_source(generator, row_seeds, data_index: int, device):
    """This data shard's draw source. A threefry key is folded with the data
    index (``fold_in(rng, data_index)``, as the JAX package's shard_map
    does) unless ``row_seeds`` give every row its own stream. A
    ``torch.Generator`` (``None``: the default one) gives a base seed that
    rank 0 broadcasts, so every rank starts from the same one, and each
    data shard seeds a generator of its own from it; like the unsharded
    ``torch.Generator`` path it matches the JAX package in distribution
    only."""
    if isinstance(generator, torch.Tensor):
        if row_seeds is not None:
            return generator
        return prng.fold_in(generator.to(device), torch.tensor(
            data_index, dtype=torch.int64, device=device))
    gen = generator if generator is not None else torch.default_generator
    base = torch.randint(0, 2 ** 62, (1,), generator=gen,
                         device=gen.device).to(device)
    torch.distributed.broadcast(base, src=0)
    seed = (int(base) + 0x9E3779B97F4A7C15 * (data_index + 1)) % 2 ** 63
    return torch.Generator(device=device).manual_seed(seed)


def _local_params(params: Dict, mcfg: ModelConfig, mesh) -> Dict:
    """This rank's TP shard: ``params`` at the model's full width are cut
    (:func:`~mmtg_tpu_torch.parallel.mesh.shard_decode_params`); a tree at
    the shard's width is taken as this rank's shard already."""
    tp = pmesh.mesh_sizes(mesh)[1]
    width = params["gpt2"]["h"]["attn_w"].shape[-1]
    D, g = mcfg.gpt2.n_embd, mcfg.gpt2
    if width == 3 * D:
        return pmesh.shard_decode_params(params, mesh, g.n_head, g.head_dim)
    if tp > 1 and width * tp == 3 * D:
        return params
    raise ValueError(f"QKV width {width} is neither the model's ({3 * D}) nor "
                     f"a 1/{tp} shard of it")


def _check_tp_agreement(tokens: torch.Tensor, model_group, tp: int) -> None:
    """The ranks of a data shard sample from the same logits with the same
    streams; if their tokens part, their caches would part silently. Raise
    on any difference."""
    if tp == 1:
        return
    every = pmesh.all_gather_cat(tokens[None], model_group)
    if not bool((every == every[:1]).all()):
        raise RuntimeError("tensor-parallel ranks of one data shard sampled "
                           "different tokens")


def _sharded_setup(params, const, mcfg, dcfg, gcfg, batch, generator, mesh,
                   row_seeds):
    """This rank's part of a sharded call: its rows, stream, shard and the
    decode state of :func:`_decode_setup` over them."""
    tp = pmesh.mesh_sizes(mesh)[1]
    data_index = pmesh.mesh_coords(mesh)[0]
    data_group, model_group = pmesh.groups(mesh)
    global_b = batch["topic_ids"].shape[0]
    gcfg = _resolve_sharded_gcfg(gcfg, global_b)
    rows = pmesh.local_rows(global_b, mesh)
    local = {k: v[rows] for k, v in batch.items()}
    seeds = row_seeds[rows] if row_seeds is not None else None
    dev = batch["topic_ids"].device
    source = _shard_source(generator, row_seeds, data_index, dev)
    tp_group = model_group if tp > 1 else None
    state, step = _decode_setup(_local_params(params, mcfg, mesh), const, mcfg,
                                dcfg, gcfg, local, source, seeds, tp_group)
    return gcfg, state, step, data_group, model_group, tp


@torch.no_grad()
def generate_sharded(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    gcfg: GenerateConfig,
    batch: Dict[str, torch.Tensor],
    generator: Union[torch.Generator, torch.Tensor, None],
    mesh,
    row_seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Data x tensor-parallel generation over a ``(data, model)`` mesh
    (:func:`mmtg_tpu_torch.parallel.mesh.make_mesh`).

    Every rank calls it with the GLOBAL batch (on its own device) and the
    same ``params`` — the full tree, or this rank's TP shard of it — and
    ``generator``. Data shard ``d`` decodes rows ``[d B/dp, (d+1) B/dp)``;
    with ``model`` > 1 its ranks run the GPT-2 decoder tensor-parallel: each
    holds its heads' QKV / MLP columns and KV cache (``n_head / tp`` heads,
    ``D / tp`` lanes: the per-layer kernels run at that shape), the
    row-parallel products are summed over the ``model`` group, and every
    rank of the shard samples the same tokens from the same logits (checked
    at the end: a difference raises). The tokens are gathered over ``data``,
    so every rank returns the global ``[B, 1 + length]``.

    Without ``row_seeds`` a threefry key is folded with the data index, as
    in the JAX package, so the shards sample independently. With
    ``row_seeds`` (threefry key) every row has its own stream and the
    tokens are those of the single-device :func:`generate`, row for row, on
    any mesh. ``auto`` precisions pin from the global batch; the cache's
    resolves to the model dtype. The whole-step kernel (``fused``) runs on
    DP-only meshes; under TP the per-layer kernels do.
    """
    with span("decode.call"):
        gcfg, state, step, data_group, model_group, tp = _sharded_setup(
            params, const, mcfg, dcfg, gcfg, batch, generator, mesh, row_seeds)
        for i in range(gcfg.length):
            step(i)
        _check_tp_agreement(state.tokens, model_group, tp)
        return pmesh.all_gather_cat(state.tokens, data_group)


def generate_stream_sharded(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    gcfg: GenerateConfig,
    batch: Dict[str, torch.Tensor],
    generator: Union[torch.Generator, torch.Tensor, None],
    mesh,
    row_seeds: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
) -> Iterator[torch.Tensor]:
    """:func:`generate_sharded` in blocks: yield global ``[B, n]`` int32
    blocks of ``chunk`` steps (default one 22-token sentence), equal token
    for token to :func:`generate_sharded` on the same mesh (and, with
    ``row_seeds``, to :func:`generate`). Every rank iterates in step. The
    decode state stays on each rank between blocks; each block is checked
    for TP agreement and gathered over ``data`` before it is yielded. A
    quantized cache under TP raises, as in the JAX package."""
    tp = pmesh.mesh_sizes(mesh)[1]
    global_b = batch["topic_ids"].shape[0]
    if tp > 1 and _resolve_sharded_gcfg(gcfg, global_b).cache_dtype in ("int8", "int4"):
        raise ValueError(
            "generate_stream_sharded: a quantized KV cache under tensor "
            "parallelism is not streamable (shard-local scales, as in the JAX "
            "package); use cache_dtype='model' (the sharded 'auto') or a "
            "DP-only mesh")
    chunk = dcfg.sent_frame_length if chunk is None else chunk
    chunk = max(1, min(int(chunk), gcfg.length))
    with torch.no_grad(), span("decode.call"):
        gcfg, state, step, data_group, model_group, tp = _sharded_setup(
            params, const, mcfg, dcfg, gcfg, batch, generator, mesh, row_seeds)
    start = 0
    while start < gcfg.length:
        n = min(chunk, gcfg.length - start)
        with torch.no_grad(), span("decode.call"):  # not held across the yield
            for i in range(start, start + n):
                step(i)
            block = state.tokens[:, start + 1:start + n + 1].contiguous()
            _check_tp_agreement(block, model_group, tp)
            block = pmesh.all_gather_cat(block, data_group)
        yield block
        start += n


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
