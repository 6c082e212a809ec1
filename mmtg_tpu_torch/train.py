"""Curriculum trainer on the PyTorch port (:mod:`mmtg_tpu.train`).

CLI-parity rebuild of the reference trainer (``train.py:33-268``): identical
flag names and defaults, identical optimization recipe (AdamW lr 1e-5 / eps
1e-6 / wd 0, linear warmup over 10% of one epoch then linear decay to 0;
global-norm grad clip 1.0), identical curriculum semantics (stage-by-epoch
with a 2× batch in stage 1 and rating-based filtering) — with one shape for
every stage and batch: filtering is a 0/1 sample-weight mask.

The GPT-2 stack attends through the hand-written train-attention kernels
(:mod:`mmtg_tpu_torch.ops.train_attention`) for CUDA tensors:
``mha_train_packed`` on parity rows, ``mha_train_packed_seg`` on the packed
rows of ``--pack_sequences`` (:mod:`mmtg_tpu_torch.pack`; a NON-parity
objective, see there; eval stays unpacked). Master
parameters and AdamW moments are f32; ``--dtype bfloat16`` computes in bf16
through a differentiable cast. The train state is UPDATED IN PLACE by a step
(the JAX step donates its input state).

    python -m mmtg_tpu_torch.train --train_data_path train.pkl \\
        --val_data_path val.pkl --vocab_path vocab/vocab.txt \\
        --token_emb_path token_id2emb_dict.pkl --save_model --save_path ckpt

``--profile_dir DIR`` writes a ``torch.profiler`` Chrome trace of steps
10-30 of the first epoch into DIR (:func:`mmtg_tpu_torch.utils.logging.maybe_profile`).
``--gpt2_ckpt`` reads ``pytorch_model.bin`` and ``model.safetensors``
snapshots and reference ``.pth`` files.

Remat (``TrainConfig.remat``, off with ``--no_remat``) keeps what
``TrainConfig.remat_policy`` names for the backward
(:data:`mmtg_tpu_torch.models.gpt2.REMAT_POLICIES`); ``"auto"`` resolves as
the JAX trainer does (:func:`_resolve_remat_policy`).

Meshes, one process a rank under ``torchrun``
(:mod:`mmtg_tpu_torch.parallel.mesh`, :mod:`mmtg_tpu_torch.parallel.pipeline`):
``--mesh_data`` (0 = every rank of the job) x ``--mesh_model`` (Megatron
tensor parallelism) or x ``--mesh_pipe`` (GPipe, ``--pp_microbatches``),
``--zero1`` (the AdamW moments split over ``data``) and ``--multihost`` (a
job whose ranks span nodes). The objective, the clip norm and the no-op of a
batch that keeps no sample are the global batch's, so a mesh step equals the
single-device step on the same global batch (dropout aside: its masks depend
on the ranks' shapes). Every rank reads the same shuffled order and takes its
rows; rank 0 logs and writes the FULL train state (parameters and moments
gathered), which single-device ``generate`` / ``serve`` / ``--resume`` load
and ``--resume`` on a mesh re-shards::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m mmtg_tpu_torch.train --mesh_data 2 --zero1 ...

A JAX run's Orbax train state (``<save_path>/orbax``) or a JAX pretrain
directory becomes the port's with ``scripts/orbax_to_torch.py``, outside the
package (it needs JAX and Orbax).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import math
import os
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mmtg_tpu_torch.configs import DataConfig, ModelConfig, TrainConfig
from mmtg_tpu_torch.loss import (
    curriculum_sample_weights,
    packed_sequence_unlikelihood_loss,
    packed_sequence_unlikelihood_loss_from_hidden,
    sequence_unlikelihood_loss,
    sequence_unlikelihood_loss_from_hidden,
    stage_for_epoch,
    weighted_mean,
)
from mmtg_tpu_torch.models.mmtg import (
    mmtg_forward_train,
    mmtg_forward_train_packed,
)
from mmtg_tpu_torch.models.gpt2 import DATA_SALT, fold_seed
from mmtg_tpu_torch.parallel import mesh as pmesh
from mmtg_tpu_torch.parallel.pipeline import gather_params_pp, shard_params_pp
from mmtg_tpu_torch.params import init_params, tree_leaves, tree_map
from mmtg_tpu_torch.utils.logging import (
    StepTimer,
    format_time,
    maybe_profile,
    setup_logger,
)


class TrainState(NamedTuple):
    params: Any  # f32 master parameters (leaves require grad)
    opt_state: Any  # AdamW state: {"count", "mu", "nu"}
    step: int
    rng: torch.Generator  # CPU generator: draws the dropout seeds


def make_schedule(tcfg: TrainConfig, warmup_steps: int, total_steps: int):
    """Linear warmup → linear decay to 0 (``get_linear_schedule_with_warmup``,
    reference ``train.py:146-148``), as a function of the optimizer's update
    count (a tensor or a number). The first update, count 0, has rate 0."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count):
        c = torch.as_tensor(count).to(torch.float32)
        up = tcfg.lr * (c.clamp(0, warm) / warm)
        down = tcfg.lr * (1.0 - (c - warm).clamp(0, decay) / decay)
        return torch.where(c < warm, up, down)

    return schedule


class AdamW:
    """Clip by global norm, then AdamW with a learning-rate schedule — the
    chain ``optax.chain(clip_by_global_norm, adamw(schedule))`` of the JAX
    trainer: ``eps`` outside the bias-corrected square root, decoupled
    weight decay, the rate read at the count BEFORE the update. The state
    lives on the parameters' device and a step reads nothing back to the
    host."""

    def __init__(self, schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float):
        self.schedule, self.b1, self.b2 = schedule, b1, b2
        self.eps, self.weight_decay, self.clip_norm = eps, weight_decay, clip_norm

    def init(self, params) -> Dict:
        dev = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,  # noqa: E731
                                           requires_grad=False)
        return {"count": torch.zeros((), dtype=torch.int64, device=dev),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update_(self, params, grads, opt_state, keep: torch.Tensor,
                norm: Optional[torch.Tensor] = None) -> None:
        """One update IN PLACE of ``params`` and ``opt_state``. Where the
        0-dim bool ``keep`` is False nothing changes: neither parameters nor
        moments nor the count (and so the schedule). ``norm``: the global
        gradient norm to clip by, when ``grads`` are a part of the whole
        (a mesh rank's shards), else computed from ``grads``."""
        leaves, gs = tree_leaves(params), tree_leaves(grads)
        mus, nus = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
        if norm is None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in gs))
        clip = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                           self.clip_norm / norm)
        count = opt_state["count"]
        lr = self.schedule(count)
        t = (count + 1).to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, device=t.device), t)
        for p, g, mu, nu in zip(leaves, gs, mus, nus):
            g = g.float() * clip
            mu_new = self.b1 * mu + (1.0 - self.b1) * g
            nu_new = self.b2 * nu + (1.0 - self.b2) * g.square()
            upd = (mu_new / c1) / (torch.sqrt(nu_new / c2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.copy_(torch.where(keep, p - lr * upd, p))
            mu.copy_(torch.where(keep, mu_new, mu))
            nu.copy_(torch.where(keep, nu_new, nu))
        count.add_(keep.to(count.dtype))


def make_optimizer(tcfg: TrainConfig, warmup_steps: int, total_steps: int) -> AdamW:
    return AdamW(make_schedule(tcfg, warmup_steps, total_steps),
                 b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
                 weight_decay=tcfg.weight_decay, clip_norm=tcfg.grad_clip_norm)


def create_train_state(
    seed: int,
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    warmup_steps: int,
    total_steps: int,
    params: Optional[Dict] = None,
    *,
    device,
) -> Tuple[TrainState, AdamW]:
    """A fresh state on ``device`` (required: ``"cuda"``, or ``"cpu"`` when
    the caller means the CPU): seeded parameters (or ``params``, moved
    and cast to f32), zero moments, step 0, a CPU generator seeded with
    ``seed + 1`` for the dropout seeds."""
    if params is None:
        params = init_params(mcfg, seed=seed)
    params = tree_map(
        lambda p: p.detach().to(device=device, dtype=torch.float32)
        .clone().requires_grad_(True), params)
    tx = make_optimizer(tcfg, warmup_steps, total_steps)
    rng = torch.Generator().manual_seed(seed + 1)
    return TrainState(params, tx.init(params), 0, rng), tx


def _resolve_loss_impl(impl: str, batch: Dict[str, torch.Tensor], vocab: int) -> str:
    """``auto`` → "full" when the materialized-logits path is small (about
    6·B·T·V bytes: the logits plus an f32 log-softmax in the backward), else
    "chunked"; identical loss value either way. The 5e9-byte threshold is
    the JAX package's, kept for parity."""
    if impl != "auto":
        return impl
    B, T = (batch["tokens"] if "tokens" in batch else batch["targets"]).shape
    return "full" if 6 * B * T * vocab < 5e9 else "chunked"


def _resolve_remat_policy(policy: str, batch=None, pp=None,
                          prompt_len: int = 15, data_size: int = 1) -> str:
    """``"auto"`` → ``"save_qkv_ctx"`` when the kept pair fits, else
    ``"full"`` (the JAX trainer's rule): qkv + ctx are about ``73728·B·Tp``
    bytes over 12 layers (``Tp`` the sequence padded to 128: the packed
    rows, or the targets behind the ``prompt_len`` topic prompt), and the
    gate is 5e9 bytes, set by the JAX package for a 16 GB TPU chip and kept
    for parity. The pipeline and a call without a batch keep ``"full"``.
    ``batch`` is this rank's rows: ``B`` counts them ``data_size`` times (the
    JAX step is one program over the global batch). Other names pass."""
    if policy != "auto":
        return policy
    if pp is not None or batch is None:
        return "full"
    if "tokens" in batch:  # packed rows
        B, T = batch["tokens"].shape
    else:
        B, T = batch["targets"].shape
        T += prompt_len
    Tp = ((T + 127) // 128) * 128  # the attention kernels' sequence pad
    return "save_qkv_ctx" if 73728 * B * data_size * Tp <= 5e9 else "full"


def loss_and_metrics(
    params: Dict,
    const: Dict,
    mcfg: ModelConfig,
    dcfg: DataConfig,
    tcfg: TrainConfig,
    batch: Dict[str, torch.Tensor],
    stage: int,
    dropout_gen: Optional[torch.Generator],
    deterministic: bool,
    tp_group=None,
    pp=None,
    data_size: int = 1,
):
    """total = unlikelihood(curriculum-masked) + alpha·KL
    (reference ``train.py:191-192``) over this rank's rows. Returns (total,
    metrics). ``tp_group`` / ``pp``: the GPT-2 stack tensor-parallel or
    pipelined (:func:`~mmtg_tpu_torch.models.gpt2.gpt2_forward`); the
    pipeline path always recomputes a stage in the backward (full remat).
    ``data_size``: the ranks of the ``data`` axis, whose rows together are
    the batch that ``"auto"`` resolves on (:func:`_resolve_remat_policy`)."""
    remat_policy = _resolve_remat_policy(
        tcfg.remat_policy, batch, pp, dcfg.topic_prompt_length, data_size)
    if tcfg.dtype == "bfloat16":
        # mixed precision: f32 master params/optimizer, bf16 compute (the
        # cast is differentiable, so gradients land back in f32); the loss
        # itself always reduces in f32
        cast = lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x  # noqa: E731
        fwd_params = tree_map(cast, params)
        fwd_const = tree_map(cast, const)
    else:
        fwd_params, fwd_const = params, const
    chunked = _resolve_loss_impl(tcfg.loss_impl, batch,
                                 mcfg.gpt2.vocab_size) == "chunked"
    if "seg" in batch:
        # --pack_sequences: segment-packed rows (mmtg_tpu_torch.pack). The
        # NON-parity objective — per-slot CE over real labels only — is the
        # whole point; see pack.py's token-accounting contract.
        out = mmtg_forward_train_packed(
            fwd_params, fwd_const, mcfg, dcfg, batch,
            dropout_gen=dropout_gen, deterministic=deterministic,
            remat=tcfg.remat and not deterministic, attn_impl=tcfg.attn_impl,
            lm_head=not chunked, tp_group=tp_group, pp=pp,
            remat_policy=remat_policy)
        if chunked:
            loss, weights, _ = packed_sequence_unlikelihood_loss_from_hidden(
                out.hidden, fwd_params["gpt2"]["wte"], batch, stage)
        else:
            loss, weights, _ = packed_sequence_unlikelihood_loss(
                out.logits, batch, stage)
        kl = weighted_mean(out.kl_per_sample.float().reshape(-1), weights)
        total = loss + tcfg.alpha * kl
        return total, {"loss": loss.detach(), "kl": kl.detach(),
                       "total": total.detach(), "kept": weights.sum()}
    out = mmtg_forward_train(
        fwd_params, fwd_const, mcfg, dcfg, batch,
        dropout_gen=dropout_gen, deterministic=deterministic,
        remat=tcfg.remat and not deterministic, attn_impl=tcfg.attn_impl,
        lm_head=not chunked, tp_group=tp_group, pp=pp,
        remat_policy=remat_policy)
    ratings = batch["rating"]
    weights = curriculum_sample_weights(ratings, stage)
    if "sample_mask" in batch:
        weights = weights * batch["sample_mask"]
    if chunked:
        loss = sequence_unlikelihood_loss_from_hidden(
            out.hidden, fwd_params["gpt2"]["wte"], batch["targets"], ratings,
            stage, dcfg, weights)
    else:
        loss = sequence_unlikelihood_loss(out.logits, batch["targets"], ratings,
                                          stage, dcfg, weights)
    kl = weighted_mean(out.kl_per_sample.float(), weights)
    total = loss + tcfg.alpha * kl
    return total, {"loss": loss.detach(), "kl": kl.detach(),
                   "total": total.detach(), "kept": weights.sum()}


def _numerators(params, const, mcfg, dcfg, tcfg, batch, stage, rng, **mesh_kw):
    """The batch's gradient and metric NUMERATORS: each of ``tcfg.grad_accum``
    sequential chunks adds ``grad(total_c)·max(kept_c, 1)`` and ``m_c·max(
    kept_c, 1)`` (a chunk's total is a kept-weighted mean, so these sum to
    the whole batch's numerator). Returns (gradient leaves, ``[loss, kl,
    total, kept]`` numerators)."""
    leaves = tree_leaves(params)
    N = tcfg.grad_accum
    # every batch leaf is batch-leading (parity rows or packed rows)
    B = next(iter(batch.values())).shape[0]
    if B % N:
        raise ValueError(f"batch {B} not divisible by grad_accum {N}")
    g_acc, num = None, None
    for i in range(N):
        chunk = batch if N == 1 else {k: v[i * (B // N):(i + 1) * (B // N)]
                                      for k, v in batch.items()}
        total, m = loss_and_metrics(params, const, mcfg, dcfg, tcfg, chunk,
                                    stage, rng, False, **mesh_kw)
        k = m["kept"].clamp_min(1.0)
        gs = torch.autograd.grad(total * k, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
        m_num = torch.stack([m["loss"] * k, m["kl"] * k, m["total"] * k,
                             m["kept"]]).float()
        if g_acc is None:
            g_acc, num = gs, m_num
        else:
            for acc, g in zip(g_acc, gs):
                acc.add_(g)
            num = num + m_num
    return g_acc, num


def _metrics(num: torch.Tensor) -> Dict[str, torch.Tensor]:
    denom = num[3].clamp_min(1.0)
    return {"loss": num[0] / denom, "kl": num[1] / denom,
            "total": num[2] / denom, "kept": num[3]}


class _MeshSums:
    """The reductions of a mesh step (:class:`mmtg_tpu_torch.parallel.mesh.
    TrainLayout`): the replicated leaves' gradients and the metric
    numerators in one vector summed over the whole job (ranks off part 0
    contribute zeros), the sharded leaves' in one vector summed over
    ``data``; then the global clip norm, whose sharded part is summed over
    the ``model`` / ``pipe`` group."""

    def __init__(self, layout, params):
        self.layout = layout
        self.sharded = layout.sharded_mask(params)

    def _cat(self, tensors):
        return torch.cat([t.reshape(-1) for t in tensors])

    def _split(self, flat, like):
        out, at = [], 0
        for t in like:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return out

    def reduce(self, grads, num):
        """(gradients of the global batch, metric numerators of the global
        batch, the global gradient norm)."""
        lay = self.layout
        rep = [g for g, s in zip(grads, self.sharded) if not s]
        shd = [g for g, s in zip(grads, self.sharded) if s]
        flat = self._cat(rep + [num])
        if lay.part > 0:
            flat.zero_()
        pmesh.all_reduce_(flat, None)
        num = flat[-4:]
        denom = num[3].clamp_min(1.0)
        rep = [g / denom for g in self._split(flat[:-4], rep)]
        norm2 = sum(g.square().sum() for g in rep)
        if shd:
            flat = pmesh.all_reduce_(self._cat(shd), lay.data_group)
            shd = [g / denom for g in self._split(flat, shd)]
            part = torch.stack([g.square().sum() for g in shd]).sum()
            norm2 = norm2 + pmesh.all_reduce_(part, lay.split_group)
        rep_it, shd_it = iter(rep), iter(shd)
        grads = [next(shd_it) if s else next(rep_it) for s in self.sharded]
        return grads, num, torch.sqrt(norm2)


def make_train_step(mcfg, dcfg, tcfg, tx: AdamW, pp=None, zero1: bool = False,
                    mesh=None):
    """One train step (grad → clip → AdamW → apply), in place on the state.

    ``tcfg.grad_accum`` = N splits the batch into N sequential micro-chunks
    with EXACT recombination: a chunk's total is a kept-weighted mean, so
    ``grad(total_c)·max(kept_c, 1)`` accumulates to the full-batch numerator
    and one division by ``max(Σkept, 1)`` restores the objective — identical
    gradients for any row→chunk assignment.

    A batch whose curriculum keeps no sample is a true no-op (the reference
    ``continue``s before the optimizer and the scheduler): parameters,
    moments and the schedule count stay, only ``step`` advances. The test is
    made on the device (``torch.where`` in :meth:`AdamW.update_`), so a step
    reads nothing back to the host.

    On a mesh (``mesh`` a ``("data", "model")`` ``DeviceMesh``, or ``pp =
    (mesh, n_micro)`` with a ``("data", "pipe")`` one) the state holds this
    rank's shard (:func:`shard_train_state`) and the batch its rows. The
    same recombination runs over ``data``: each rank's numerators are summed
    over the job and divided once by ``max(Σkept, 1)`` of the GLOBAL batch
    (a mean of the ranks' means would be another objective when the ranks
    keep different counts), and the no-op is decided from the global
    ``Σkept``, so every rank steps or none does. The clip norm is the whole
    model's. ``zero1``: each data rank updates its ``1/dp`` of the moments
    (:class:`~mmtg_tpu_torch.parallel.mesh.Zero1Partition`) and one
    ``all_gather`` over ``data`` rebuilds the parameters. Dropout: the
    step's seed is folded with the data index (every data shard its own
    masks; the same masks on the TP ranks and stages of a shard)."""
    if pp is not None:
        mesh = pp[0]
    if mesh is None:
        if zero1:
            raise ValueError("zero1 needs a mesh")
        return _single_device_step(mcfg, dcfg, tcfg, tx)
    layout = pmesh.train_layout(mesh)
    if zero1 and layout.pp > 1:
        raise ValueError(ZERO1_PIPE_ERROR)
    mesh_kw = dict(tp_group=layout.split_group if layout.tp > 1 else None, pp=pp,
                   data_size=layout.dp)

    def train_step(state: TrainState, const: Dict, batch: Dict, stage: int):
        base = int(torch.randint(0, 2 ** 62, (1,), generator=state.rng))
        gen = torch.Generator().manual_seed(
            fold_seed(base, layout.data_index, DATA_SALT))
        grads, num = _numerators(state.params, const, mcfg, dcfg, tcfg, batch,
                                 int(stage), gen, **mesh_kw)
        grads, num, norm = _MeshSums(layout, state.params).reduce(grads, num)
        metrics = _metrics(num)
        keep = metrics["kept"] > 0
        leaves = tree_leaves(state.params)
        if not zero1:
            tx.update_(leaves, grads, state.opt_state, keep, norm=norm)
        else:
            part = pmesh.Zero1Partition(leaves, layout.dp, layout.data_index)
            mine = part.local(part.flat(leaves)).clone()
            tx.update_([mine], [part.local(part.flat(grads))], state.opt_state,
                       keep, norm=norm)
            with torch.no_grad():
                for p, new in zip(leaves, part.unflat(part.gather(mine,
                                                                  layout.data_group))):
                    p.copy_(new)
        return state._replace(step=state.step + 1), metrics

    return train_step


def _single_device_step(mcfg, dcfg, tcfg, tx):
    def train_step(state: TrainState, const: Dict, batch: Dict, stage: int):
        grads, num = _numerators(state.params, const, mcfg, dcfg, tcfg, batch,
                                 int(stage), state.rng)
        metrics = _metrics(num)
        denom = metrics["kept"].clamp_min(1.0)
        # tree_leaves order on both sides
        tx.update_(tree_leaves(state.params), [g / denom for g in grads],
                   state.opt_state, metrics["kept"] > 0)
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_eval_step(mcfg, dcfg, tcfg, pp=None, mesh=None):
    """The metrics of a batch, no dropout. On a mesh (as
    :func:`make_train_step`) the batch is this rank's rows and the metrics
    are the global batch's: kept-weighted numerators summed over ``data``."""
    if pp is not None:
        mesh = pp[0]
    layout = pmesh.train_layout(mesh) if mesh is not None else None
    tp_group = layout.split_group if layout is not None and layout.tp > 1 else None

    @torch.no_grad()
    def eval_step(params: Dict, const: Dict, batch: Dict, stage: int):
        _, m = loss_and_metrics(params, const, mcfg, dcfg, tcfg, batch,
                                int(stage), None, True, tp_group=tp_group, pp=pp)
        if layout is None:
            return m
        k = m["kept"].clamp_min(1.0)
        num = torch.stack([m["loss"] * k, m["kl"] * k, m["total"] * k,
                           m["kept"]]).float()
        if layout.part > 0:
            num.zero_()
        return _metrics(pmesh.all_reduce_(num, None))

    return eval_step


# ---------------------------------------------------------------------------
# The train state on a mesh
# ---------------------------------------------------------------------------


def _unflatten(tree, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _local_tree(tree, mcfg, layout):
    if layout.pp > 1:
        return shard_params_pp(tree, layout.pp, layout.part)
    g = mcfg.gpt2
    return pmesh.decode_shard(tree, g.n_head, g.head_dim, layout.tp, layout.part)


def _full_tree(tree, mcfg, layout):
    if layout.pp > 1:
        return gather_params_pp(tree, layout.split_group)
    g = mcfg.gpt2
    return pmesh.gather_params(tree, g.n_head, g.head_dim, layout.split_group)


def shard_train_state(state: TrainState, mcfg: ModelConfig, mesh,
                      zero1: bool = False) -> TrainState:
    """A full train state (every rank holds the same one) → this rank's
    shard on ``mesh``: its TP shard or stage of the parameters and moments
    (``zero1``: its flat ``1/dp`` chunk of the moments,
    :class:`~mmtg_tpu_torch.parallel.mesh.Zero1Partition`). Copies: the
    full state may be dropped."""
    layout = pmesh.train_layout(mesh)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      _local_tree(state.params, mcfg, layout))
    mu, nu = (tree_map(lambda x: x.detach().clone(),
                       _local_tree(state.opt_state[k], mcfg, layout))
              for k in ("mu", "nu"))
    if zero1:
        part = pmesh.Zero1Partition(tree_leaves(params), layout.dp,
                                    layout.data_index)
        mu, nu = (part.local(part.flat(tree_leaves(t))).clone() for t in (mu, nu))
    opt = {"count": state.opt_state["count"].clone(), "mu": mu, "nu": nu}
    return TrainState(params, opt, state.step, state.rng)


def gather_train_state(state: TrainState, mcfg: ModelConfig, mesh,
                       zero1: bool = False) -> TrainState:
    """Inverse of :func:`shard_train_state`: the FULL single-device state,
    assembled on every rank (every rank must call it: it gathers)."""
    layout = pmesh.train_layout(mesh)
    mu, nu = state.opt_state["mu"], state.opt_state["nu"]
    if zero1:
        leaves = tree_leaves(state.params)
        part = pmesh.Zero1Partition(leaves, layout.dp, layout.data_index)
        mu, nu = (_unflatten(state.params, [x.clone() for x in part.unflat(
            part.gather(t, layout.data_group))]) for t in (mu, nu))
    params = tree_map(lambda p: p.detach(), state.params)
    full = [_full_tree(t, mcfg, layout) for t in (params, mu, nu)]
    opt = {"count": state.opt_state["count"], "mu": full[1], "nu": full[2]}
    return TrainState(full[0], opt, state.step, state.rng)


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def local_batch(batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch (every leaf batch-leading); the
    batch must divide over the mesh's ``data`` axis."""
    if mesh is None:
        return batch
    rows = pmesh.local_rows(next(iter(batch.values())).shape[0], mesh)
    return {k: v[rows] for k, v in batch.items()}


def evaluate(eval_step, params, const, dataset, batch_size, stage,
             device, mesh=None) -> Tuple[float, float]:
    """Mean val loss over the set (reference ``train.py:241-268``): batches
    with zero kept samples contribute 0, faithful to the reference's
    ``continue``-then-divide-by-len behavior. On a mesh each rank evaluates
    its rows of every batch."""
    losses, kls, n = 0.0, 0.0, 0
    for batch in dataset.batches(batch_size):
        m = eval_step(params, const, _to_device(local_batch(batch, mesh), device),
                      stage)
        if float(m["kept"]) > 0:
            losses += float(m["total"])
            kls += float(m["kl"])
        n += 1
    return losses / max(n, 1), kls / max(n, 1)


# ---------------------------------------------------------------------------
# CLI (flag names/defaults per reference train.py:33-51 + train.sh)
# ---------------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MMTG trainer (PyTorch)")
    p.add_argument("--device_ids", default="0", type=str, help="parity no-op")
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--val_batch_size", default=32, type=int)
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--lr", default=1e-05, type=float)
    p.add_argument("--curriculums", default="1,3", type=str,
                   help="two ints, e.g. '1,3' (also accepts '[1,3]')")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--num_workers", default=0, type=int,
                   help="parity no-op (data is pre-packed, no loader workers)")
    p.add_argument("--log_interval", default=100, type=int)
    p.add_argument("--val_interval_ratio", default=0.2, type=float)
    p.add_argument("--train_data_path", default="", type=str)
    p.add_argument("--val_data_path", default="", type=str)
    p.add_argument("--save_model", action="store_true")
    p.add_argument("--save_path", default="", type=str)
    p.add_argument("--log_path", default="", type=str)
    p.add_argument("--alpha", default=0, type=float, help="Factor of KL loss")
    p.add_argument("--vocab_path", default="./vocab/vocab.txt", type=str)
    p.add_argument("--token_emb_path", default="./vocab/token_id2emb_dict.pkl", type=str)
    p.add_argument("--gpt2_ckpt", default="", type=str,
                   help="phase-1 GPT-2 .pth/.ckpt (or an HF directory with "
                        "pytorch_model.bin or model.safetensors) to initialize "
                        "the decoder; scripts/orbax_to_torch.py converts a JAX "
                        "pretrain directory")
    p.add_argument("--resume", action="store_true", help="resume from save_path")
    p.add_argument("--mesh_data", default=0, type=int,
                   help="data-parallel mesh size (0 = every rank of the "
                        "torchrun job over --mesh_model x --mesh_pipe)")
    p.add_argument("--mesh_model", default=1, type=int,
                   help="tensor-parallel ranks a data shard (Megatron: heads "
                        "and MLP columns split; run under torchrun)")
    p.add_argument("--mesh_pipe", default=1, type=int,
                   help="pipeline-parallel stages (GPipe over the GPT-2 "
                        "layer stack; mutually exclusive with --mesh_model)")
    p.add_argument("--pp_microbatches", default=0, type=int,
                   help="microbatches per pipelined step (0 = the largest "
                        "M <= 2x stages dividing every per-rank batch)")
    p.add_argument("--grad_accum", default=1, type=int,
                   help="split each batch into N sequential micro-chunks "
                        "(exact recombination under curriculum weights)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the AdamW moments over the data axis "
                        "(1/dp optimizer bytes a rank; one all_gather over "
                        "data rebuilds the parameters)")
    p.add_argument("--pack_sequences", action="store_true",
                   help="EXPLICITLY NON-PARITY throughput mode: drop PAD "
                        "tokens, pack samples into segment-masked rows "
                        "(mmtg_tpu_torch.pack). Changes the objective's token "
                        "accounting (per-sample CE over real labels, not "
                        "the fixed 220 grid); eval stays parity/unpacked.")
    p.add_argument("--pack_row_len", default=512, type=int,
                   help="packed row length (a multiple of 128, at most 1024, "
                        "for the attention kernel). Longer rows pack more "
                        "samples each (less dead tail) but pay quadratic "
                        "in-row attention")
    p.add_argument("--pack_slots", default=8, type=int,
                   help="max samples per packed row")
    p.add_argument("--pack_rows", default=0, type=int,
                   help="rows per packed step (0 = auto: about the token "
                        "budget of --batch_size parity rows)")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler trace of steps 10-30 of the "
                        "first epoch into this directory")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection (fail fast on NaN)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (f32 master params either way)")
    p.add_argument("--no_remat", action="store_true",
                   help="keep every GPT-2 block's activations instead of "
                        "recomputing them in the backward")
    p.add_argument("--model_config_json", default="", type=str,
                   help="GPT-2 config JSON (reference config/model_config.json)")
    p.add_argument("--variant", default="chinese", choices=["chinese", "english"],
                   help="'english' = CLIP embeddings + byte-level-BPE GPT-2; "
                        "--vocab_path then points at a vocab.json+merges.txt "
                        "directory")
    p.add_argument("--clip_dim", default=512, type=int,
                   help="CLIP embedding width for --variant english")
    p.add_argument("--multihost", action="store_true",
                   help="a job whose ranks span nodes (torchrun --nnodes N); "
                        "required for a job of more than one node")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda; pass 'cpu' to run "
                        "without a GPU)")
    return p


def epoch_for_step(
    last_step: int,
    n_samples: int,
    batch_size: int,
    curriculums: Tuple[int, int],
    epochs: int,
) -> int:
    """Map a restored global step count to the epoch to resume at.

    Stage-1 epochs run at 2x batch size, so they have fewer steps.
    Epoch-boundary checkpoints (last_step == cumulative steps of epoch e)
    resume at epoch e+1; a mid-epoch step count replays its containing
    epoch. Returns ``epochs`` when training already completed."""
    cum = 0
    for e in range(epochs):
        bs = 2 * batch_size if stage_for_epoch(e, curriculums) == 1 else batch_size
        cum += math.ceil(n_samples / bs)
        if last_step < cum:
            return e
    return epochs


def parse_curriculums(s: str) -> Tuple[int, int]:
    vals = [int(x) for x in s.strip("[] ").split(",")]
    if len(vals) != 2:
        raise ValueError(f"--curriculums expects two ints, got {s!r}")
    return (vals[0], vals[1])


def load_gpt2_ckpt_into(params: Dict, path: str, mcfg: ModelConfig) -> None:
    """Initialize ``params["gpt2"]`` (and, when present, the projectors)
    from ``--gpt2_ckpt``: a raw HF model directory holding
    ``pytorch_model.bin`` (read first when both are there, as in the JAX
    package) or ``model.safetensors``, or a torch ``.pth`` / ``.ckpt`` file
    — the reference's phase-1 ``GPT2_Decoder`` state dict (``gpt2.``-prefixed
    + projectors, optionally ``state_dict``-wrapped) or a raw HF
    ``GPT2LMHeadModel`` state dict (``transformer.``-prefixed). A JAX
    pretrain Orbax directory is converted first by
    ``scripts/orbax_to_torch.py``."""
    from mmtg_tpu_torch.checkpoint import read_safetensors, strip_prefix
    from mmtg_tpu_torch.models.gpt2 import import_hf_gpt2

    def checked(gpt2):
        V, D = gpt2["wte"].shape
        if (V, D) != (mcfg.gpt2.vocab_size, mcfg.gpt2.n_embd):
            raise ValueError(
                f"--gpt2_ckpt {path} has wte [{V}, {D}] but the model config "
                f"expects [{mcfg.gpt2.vocab_size}, {mcfg.gpt2.n_embd}]; pass "
                "the matching --model_config_json")
        return gpt2

    if os.path.isdir(path):
        hf_bin = os.path.join(path, "pytorch_model.bin")
        hf_st = os.path.join(path, "model.safetensors")
        if os.path.exists(hf_bin):
            raw = torch.load(hf_bin, map_location="cpu", weights_only=False)
        elif os.path.exists(hf_st):
            raw = read_safetensors(hf_st)
        else:
            raise NotImplementedError(
                f"--gpt2_ckpt {path}: a directory must hold pytorch_model.bin "
                "or model.safetensors (convert a JAX Orbax directory with "
                "scripts/orbax_to_torch.py)")
        raw = strip_prefix(raw)
        if not any(k.startswith("transformer.") for k in raw):
            raw = {f"transformer.{k}": v for k, v in raw.items()}  # GPT2Model save
        params["gpt2"] = checked(import_hf_gpt2(raw, mcfg.gpt2))
        return
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in raw:
        raw = raw["state_dict"]
    raw = strip_prefix(raw)
    if os.path.basename(path) == "pytorch_model.bin" and not any(
            k.startswith("transformer.") for k in raw):
        raw = {f"transformer.{k}": v for k, v in raw.items()}  # GPT2Model save
    if any(k.startswith("transformer.") for k in raw):
        params["gpt2"] = checked(import_hf_gpt2(raw, mcfg.gpt2))
        return
    gpt2_state = {k[len("gpt2."):]: v for k, v in raw.items()
                  if k.startswith("gpt2.")}
    params["gpt2"] = checked(import_hf_gpt2(gpt2_state, mcfg.gpt2))
    for ours, theirs in (("projector1", "projector_layer1"),
                         ("projector2", "projector_layer2")):
        if f"{theirs}.weight" in raw:
            params[ours] = {
                "w": torch.as_tensor(raw[f"{theirs}.weight"]).detach().T.contiguous(),
                "b": torch.as_tensor(raw[f"{theirs}.bias"]).detach().clone()}


ZERO1_PIPE_ERROR = ("--zero1 derives moment shardings from the TP param layout; "
                    "combine it with --mesh_data/--mesh_model, not --mesh_pipe")
PIPE_MODEL_ERROR = ("--mesh_pipe and --mesh_model are mutually exclusive (TP "
                    "decode and PP train shard the same stacked layer axis "
                    "differently)")
PACK_PIPE_ERROR = "--pack_sequences does not support pipeline parallelism"
PACK_MODEL_ERROR = ("--pack_sequences supports data parallelism only "
                    "(--mesh_model must be 1)")


def _check_mesh_flags(args) -> None:
    """The JAX trainer's rules for combining the mesh flags, with its
    messages."""
    if args.zero1 and args.mesh_pipe > 1:
        raise ValueError(ZERO1_PIPE_ERROR)
    if args.mesh_pipe > 1 and args.mesh_model > 1:
        raise ValueError(PIPE_MODEL_ERROR)
    if args.pack_sequences and args.mesh_pipe > 1:
        raise ValueError(PACK_PIPE_ERROR)
    if args.pack_sequences and args.mesh_model > 1:
        raise ValueError(PACK_MODEL_ERROR)


def _join_mesh(args, device):
    """The job's mesh, or ``(None, None, device)`` for a job of one rank
    with no mesh flag. Returns ``(mesh, pp, device)``: ``pp = (mesh,
    n_micro)`` under ``--mesh_pipe``, ``device`` this rank's (its card under
    CUDA). A mesh larger than the job raises (run it under torchrun)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    flags = (args.mesh_data > 1 or args.mesh_model > 1 or args.mesh_pipe > 1
             or args.zero1 or args.multihost)
    if world == 1 and not flags:
        return None, None, device
    pmesh.require_multihost_flag(args.multihost)
    split = args.mesh_model * args.mesh_pipe
    if world == 1 and max(args.mesh_data, 1) * split > 1:
        # no process group is joined for a mesh that cannot be laid out
        pmesh.make_mesh((args.mesh_data * args.mesh_pipe, args.mesh_model), device)
    info = pmesh.init_distributed(device)
    if world % split:
        raise ValueError(f"{world} ranks do not divide into meshes of "
                         f"{split} ranks on --mesh_model x --mesh_pipe")
    dp = args.mesh_data or world // split
    for flag, n in (("--batch_size", args.batch_size),
                    ("--val_batch_size", args.val_batch_size)):
        if n % dp:
            raise ValueError(f"{flag} {n} does not divide over --mesh_data {dp}")
    if args.mesh_pipe > 1:
        from mmtg_tpu_torch.parallel.pipeline import make_dp_pp_mesh

        mesh = make_dp_pp_mesh(dp, args.mesh_pipe, info.device)
        # the largest M <= 2 stages dividing every per-rank batch of the run
        # (train and val; stage-1 epochs double both, which keeps it)
        n_micro = args.pp_microbatches or math.gcd(
            math.gcd(args.batch_size // dp, args.val_batch_size // dp),
            2 * args.mesh_pipe) or 1
        return mesh, (mesh, n_micro), info.device
    return pmesh.make_mesh((dp, args.mesh_model), info.device), None, info.device


def main(argv=None, mcfg: Optional[ModelConfig] = None,
         dcfg: Optional[DataConfig] = None) -> float:
    """CLI entry; ``mcfg`` / ``dcfg`` are injectable so tests can drive the
    full training loop with a tiny model on the CPU."""
    args = build_arg_parser().parse_args(argv)
    _check_mesh_flags(args)
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.data import MMTGDataset, load_token_embedding_table
    from mmtg_tpu_torch.generate import resolve_device

    device = resolve_device(args.device)
    joined_here = not torch.distributed.is_initialized()
    mesh, pp, device = _join_mesh(args, device)
    rank = torch.distributed.get_rank() if mesh is not None else 0
    if rank == 0:
        logger = setup_logger(args.log_path or None)
    else:  # only rank 0 logs
        logger = setup_logger(None, name=f"mmtg_tpu_torch.rank{rank}")
        logger.setLevel(logging.WARNING)
    logger.info(str(args))
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    if mcfg is None:
        if args.variant == "english":
            from mmtg_tpu_torch.configs import english_variant

            tok = load_tokenizer(args.vocab_path)
            mcfg, en_dcfg = english_variant(clip_dim=args.clip_dim,
                                            gpt2_vocab=len(tok))
            if dcfg is None:
                dcfg = en_dcfg
        elif args.model_config_json:
            from mmtg_tpu_torch.configs import GPT2Config

            mcfg = ModelConfig(gpt2=GPT2Config.from_json_file(args.model_config_json))
        else:
            mcfg = ModelConfig()
    if dcfg is None:
        dcfg = DataConfig()
    curriculums = parse_curriculums(args.curriculums)
    tcfg = TrainConfig(
        batch_size=args.batch_size, val_batch_size=args.val_batch_size,
        epochs=args.epochs, lr=args.lr, curriculums=curriculums, seed=args.seed,
        log_interval=args.log_interval,
        val_interval_ratio=args.val_interval_ratio, alpha=args.alpha,
        dtype=args.dtype, remat=not args.no_remat, grad_accum=args.grad_accum,
    )
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise ValueError(
            f"--batch_size {args.batch_size} must be divisible by "
            f"--grad_accum {args.grad_accum} (stage-1 epochs run 2x batch, "
            "which stays divisible)")

    tokenizer = load_tokenizer(args.vocab_path)
    logger.info("Loading data...")
    train_data = MMTGDataset(args.train_data_path, tokenizer, dcfg, if_train=True)
    valid_data = MMTGDataset(args.val_data_path, tokenizer, dcfg, if_train=True)
    table = load_token_embedding_table(args.token_emb_path, len(tokenizer),
                                       dcfg.wenlan_emb_size)
    const = {"wenlan_table": torch.from_numpy(table).to(device)}
    logger.info("Data loaded.")

    # step bookkeeping (reference train.py:138-143): stage-1 epochs run at
    # 2× batch size, so fewer steps per epoch
    steps_1 = math.ceil(len(train_data) / (2 * tcfg.batch_size))
    steps_2 = math.ceil(len(train_data) / tcfg.batch_size)
    total_steps = (steps_1 * curriculums[0]
                   + steps_2 * (curriculums[1] - curriculums[0])
                   + steps_2 * (tcfg.epochs - curriculums[1]))
    warmup = int(steps_1 * tcfg.warmup_epoch_ratio)
    logger.info("Total training steps: %d", total_steps)

    params = None
    if args.gpt2_ckpt:
        logger.info("Loading pre-trained GPT2 model from %s...", args.gpt2_ckpt)
        params = init_params(mcfg, seed=tcfg.seed)
        load_gpt2_ckpt_into(params, args.gpt2_ckpt, mcfg)
        logger.info("Pre-trained GPT2 model loaded.")
    state, tx = create_train_state(tcfg.seed, mcfg, tcfg, warmup, total_steps,
                                   params, device=device)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    logger.info("* number of parameters: %d (on %s)", n_params, device)
    if mesh is not None:
        logger.info("Mesh %s %s of %d ranks (%s)%s", tuple(mesh.mesh_dim_names),
                    tuple(mesh.mesh.shape), mesh.mesh.numel(),
                    torch.distributed.get_backend(),
                    f", {pp[1]} micro-batches" if pp is not None else "")

    start_epoch = 0
    if args.resume and args.save_path:
        from mmtg_tpu_torch.checkpoint import restore_train_state

        state, last_step, saved_epoch = restore_train_state(
            os.path.join(args.save_path, "train_state"), state, with_epoch=True)
        if last_step >= 0:
            # resume the epoch loop where the restored step left off —
            # otherwise a stage-3 model would replay curriculum stage 1
            # against an already-advanced schedule. The state saves its
            # epoch (a packed epoch's steps follow its packing, not the
            # unpacked count epoch_for_step assumes); a state without one
            # (scripts/orbax_to_torch.py's) is mapped by its step
            start_epoch = (saved_epoch if saved_epoch is not None else
                           epoch_for_step(last_step, len(train_data),
                                          tcfg.batch_size, curriculums, tcfg.epochs))
            logger.info("Resumed from step %d (epoch %d)", last_step, start_epoch)
            if start_epoch >= tcfg.epochs:
                logger.warning(
                    "Checkpoint at step %d already covers all %d epochs; "
                    "nothing to train.", last_step, tcfg.epochs)
    if mesh is None:
        return _train_loop(state, tx, const, mcfg, dcfg, tcfg, train_data,
                           valid_data, curriculums, args, logger, device,
                           start_epoch=start_epoch)
    state = shard_train_state(state, mcfg, mesh, zero1=args.zero1)
    val = _train_loop(state, tx, const, mcfg, dcfg, tcfg, train_data, valid_data,
                      curriculums, args, logger, device, start_epoch=start_epoch,
                      mesh=mesh, pp=pp)
    if joined_here:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return val


def _train_loop(state, tx, const, mcfg, dcfg, tcfg, train_data, valid_data,
                curriculums, args, logger, device, start_epoch: int = 0,
                mesh=None, pp=None) -> float:
    train_step = make_train_step(mcfg, dcfg, tcfg, tx, pp=pp, zero1=args.zero1,
                                 mesh=mesh)
    eval_step = make_eval_step(mcfg, dcfg, tcfg, pp=pp, mesh=mesh)
    full_state = ((lambda st: gather_train_state(st, mcfg, mesh, zero1=args.zero1))
                  if mesh is not None else (lambda st: st))
    writer = mesh is None or torch.distributed.get_rank() == 0
    timer = StepTimer(device=device)
    best_val = float("inf")
    val_loss = float("inf")
    rng_np = np.random.default_rng(tcfg.seed)

    packer = None
    if args.pack_sequences:
        from mmtg_tpu_torch.pack import PackedBatcher

        packer = PackedBatcher(train_data.arrays(), dcfg,
                               row_len=args.pack_row_len,
                               max_slots=args.pack_slots)
        logger.info(
            "Sequence packing ON (non-parity objective): density %.3f "
            "(real/grid tokens), row_len %d, ≤%d samples/row",
            packer.density, args.pack_row_len, args.pack_slots)
    grid_len = dcfg.topic_prompt_length + dcfg.target_length

    for epoch in range(start_epoch, tcfg.epochs):
        t1 = time.time()
        stage = stage_for_epoch(epoch, curriculums)
        # stage 1 runs 2× batch then filters (reference train.py:128-135)
        bs = 2 * tcfg.batch_size if stage == 1 else tcfg.batch_size
        vbs = 2 * tcfg.val_batch_size if stage == 1 else tcfg.val_batch_size
        if packer is not None:
            # rows per step: about the token budget of bs parity rows
            rows = args.pack_rows or max(
                8, 8 * round(bs * grid_len * packer.density
                             / args.pack_row_len / 8))
            est_rows = math.ceil(len(train_data) * grid_len * packer.density
                                 / args.pack_row_len)
            steps_per_epoch = max(1, math.ceil(est_rows / rows))
            batch_iter = packer.batches(rows, shuffle=True, rng=rng_np)
        else:
            steps_per_epoch = math.ceil(len(train_data) / bs)
            batch_iter = train_data.batches(bs, shuffle=True, rng=rng_np)
        val_every = max(int(steps_per_epoch * tcfg.val_interval_ratio), 1)
        logger.info("Epoch %d/%d (stage %d)", epoch + 1, tcfg.epochs, stage)

        avg_loss, seen_steps, kept_total = 0.0, 0, 0.0
        trace = contextlib.ExitStack()  # steps 10-30 of the first epoch
        for step, batch in enumerate(batch_iter):
            tb = _to_device(local_batch(batch, mesh), device)
            if args.profile_dir and epoch == 0 and step == 10:
                trace.enter_context(maybe_profile(args.profile_dir))
                logger.info("Tracing steps 10-30 into %s", args.profile_dir)
            timer.start()
            state, metrics = train_step(state, const, tb, stage)
            avg_loss += float(metrics["loss"])  # waits for the device
            kept_total += float(metrics["kept"])
            timer.stop()
            if step == 30:
                trace.close()
            seen_steps += 1
            if step > 0 and (step + 1) % tcfg.log_interval == 0:
                logger.info(
                    "Epoch: %d, Step: %d/%d, Average loss: %.6f, "
                    "p50 step: %.1f ms, samples/s: %.1f",
                    epoch + 1, step + 1, steps_per_epoch,
                    avg_loss / seen_steps, timer.p50_ms,
                    # a packed step holds a varying number of real samples
                    timer.throughput(kept_total / seen_steps
                                     if packer is not None else bs))
            if step > 0 and (step + 1) % val_every == 0:
                val_loss, _ = evaluate(eval_step, state.params, const,
                                       valid_data, vbs, stage, device, mesh)
                logger.info("Epoch: %d, Step: %d/%d, Val. Loss: %.4f",
                            epoch + 1, step + 1, steps_per_epoch, val_loss)
                if val_loss < best_val:
                    best_val = val_loss
                    if args.save_model and args.save_path:
                        _save(args.save_path, full_state(state), "best_val",
                              logger, writer, epoch=epoch)

        trace.close()  # an epoch of fewer than 31 steps: trace what ran
        val_loss, _ = evaluate(eval_step, state.params, const, valid_data, vbs,
                               stage, device, mesh)
        logger.info("End eval of epoch %d. Val. Loss: %.4f", epoch + 1, val_loss)
        logger.info("Average loss: %.4f  Elapsed time: %s",
                    avg_loss / max(seen_steps, 1), format_time(time.time() - t1))
        if args.save_model and args.save_path:
            _save(args.save_path, full_state(state), f"epoch_{epoch + 1}",
                  logger, writer, epoch=epoch + 1)

    logger.info("Training finished.")
    return val_loss


def _save(save_path: str, state: TrainState, tag: str, logger,
          writer: bool = True, epoch: Optional[int] = None) -> None:
    """Two artifact streams like the reference's best_val_model.pth /
    epoch_{N}.pth: best-val checkpoints under train_state_best/, epoch
    checkpoints under train_state/ (which --resume reads). ``state`` is the
    full one; on a mesh only rank 0 (``writer``) writes it. ``epoch``: the
    epoch a run resumed from this state starts at (the next one after an
    epoch's end, the running one mid-epoch), saved beside it."""
    from mmtg_tpu_torch.checkpoint import save_train_state

    if not writer:
        return
    sub = "train_state_best" if tag == "best_val" else "train_state"
    save_train_state(os.path.join(save_path, sub), state.step, state, epoch=epoch)
    logger.info("Saved %s checkpoint at step %d to %s/%s", tag, state.step,
                save_path, sub)


if __name__ == "__main__":
    main()
