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

Not ported yet (the flags exist and raise): meshes (``--mesh_*``),
``--zero1``, ``--multihost``; selective remat policies; Orbax checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
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
    def update_(self, params, grads, opt_state, keep: torch.Tensor) -> None:
        """One update IN PLACE of ``params`` and ``opt_state``. Where the
        0-dim bool ``keep`` is False nothing changes: neither parameters nor
        moments nor the count (and so the schedule)."""
        leaves, gs = tree_leaves(params), tree_leaves(grads)
        mus, nus = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
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
):
    """total = unlikelihood(curriculum-masked) + alpha·KL
    (reference ``train.py:191-192``). Returns (total, metrics)."""
    if tcfg.remat_policy not in ("auto", "full"):
        raise NotImplementedError(
            f"remat_policy {tcfg.remat_policy!r}: selective remat policies "
            "are not ported yet (use 'full')")
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
            lm_head=not chunked)
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
        lm_head=not chunked)
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


def make_train_step(mcfg, dcfg, tcfg, tx: AdamW):
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
    reads nothing back to the host."""

    def grads_and_metrics(params, const, batch, stage, rng):
        leaves = tree_leaves(params)
        N = tcfg.grad_accum

        def grad_of(total):
            gs = torch.autograd.grad(total, leaves, allow_unused=True)
            return [torch.zeros_like(p) if g is None else g
                    for p, g in zip(leaves, gs)]

        if N <= 1:
            total, metrics = loss_and_metrics(params, const, mcfg, dcfg, tcfg,
                                              batch, stage, rng, False)
            return grad_of(total), metrics
        # every batch leaf is batch-leading (parity rows or packed rows)
        B = next(iter(batch.values())).shape[0]
        if B % N:
            raise ValueError(f"batch {B} not divisible by grad_accum {N}")
        g_acc = [torch.zeros_like(p) for p in leaves]
        num = {k: torch.zeros((), device=leaves[0].device)
               for k in ("loss", "kl", "total", "kept")}
        for i in range(N):
            chunk = {k: v[i * (B // N):(i + 1) * (B // N)] for k, v in batch.items()}
            total, m = loss_and_metrics(params, const, mcfg, dcfg, tcfg, chunk,
                                        stage, rng, False)
            k = m["kept"].clamp_min(1.0)
            for acc, g in zip(g_acc, grad_of(total * k)):
                acc.add_(g)
            for name in ("loss", "kl", "total"):
                num[name] = num[name] + m[name] * k
            num["kept"] = num["kept"] + m["kept"]
        denom = num["kept"].clamp_min(1.0)
        return ([g / denom for g in g_acc],
                {"loss": num["loss"] / denom, "kl": num["kl"] / denom,
                 "total": num["total"] / denom, "kept": num["kept"]})

    def train_step(state: TrainState, const: Dict, batch: Dict, stage: int):
        grads, metrics = grads_and_metrics(state.params, const, batch,
                                           int(stage), state.rng)
        # tree_leaves order on both sides
        tx.update_(tree_leaves(state.params), grads, state.opt_state,
                   metrics["kept"] > 0)
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_eval_step(mcfg, dcfg, tcfg):
    @torch.no_grad()
    def eval_step(params: Dict, const: Dict, batch: Dict, stage: int):
        _, metrics = loss_and_metrics(params, const, mcfg, dcfg, tcfg, batch,
                                      int(stage), None, True)
        return metrics

    return eval_step


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def evaluate(eval_step, params, const, dataset, batch_size, stage,
             device) -> Tuple[float, float]:
    """Mean val loss over the set (reference ``train.py:241-268``): batches
    with zero kept samples contribute 0, faithful to the reference's
    ``continue``-then-divide-by-len behavior."""
    losses, kls, n = 0.0, 0.0, 0
    for batch in dataset.batches(batch_size):
        m = eval_step(params, const, _to_device(batch, device), stage)
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
                        "pytorch_model.bin) to initialize the decoder")
    p.add_argument("--resume", action="store_true", help="resume from save_path")
    p.add_argument("--mesh_data", default=0, type=int,
                   help="parity flag: meshes are not ported (must be 0 or 1)")
    p.add_argument("--mesh_model", default=1, type=int,
                   help="parity flag: meshes are not ported (must be 1)")
    p.add_argument("--mesh_pipe", default=1, type=int,
                   help="parity flag: pipeline stages are not ported (must be 1)")
    p.add_argument("--pp_microbatches", default=0, type=int,
                   help="parity flag of --mesh_pipe")
    p.add_argument("--grad_accum", default=1, type=int,
                   help="split each batch into N sequential micro-chunks "
                        "(exact recombination under curriculum weights)")
    p.add_argument("--zero1", action="store_true", help="not ported yet")
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
    p.add_argument("--multihost", action="store_true", help="not ported yet")
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
    ``GPT2LMHeadModel`` state dict (``transformer.``-prefixed). Orbax
    directories are not ported yet."""
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
                "or model.safetensors (Orbax directories are not ported yet)")
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


def _reject_unported(args) -> None:
    unported = [
        ("--mesh_data", args.mesh_data not in (0, 1)),
        ("--mesh_model", args.mesh_model != 1),
        ("--mesh_pipe", args.mesh_pipe != 1),
        ("--zero1", args.zero1),
        ("--multihost", args.multihost),
    ]
    for flag, used in unported:
        if used:
            raise NotImplementedError(f"{flag} is not ported yet")


def main(argv=None, mcfg: Optional[ModelConfig] = None,
         dcfg: Optional[DataConfig] = None) -> float:
    """CLI entry; ``mcfg`` / ``dcfg`` are injectable so tests can drive the
    full training loop with a tiny model on the CPU."""
    args = build_arg_parser().parse_args(argv)
    _reject_unported(args)
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.data import MMTGDataset, load_token_embedding_table
    from mmtg_tpu_torch.generate import resolve_device

    device = resolve_device(args.device)
    logger = setup_logger(args.log_path or None)
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

    start_epoch = 0
    if args.resume and args.save_path:
        from mmtg_tpu_torch.checkpoint import restore_train_state

        state, last_step = restore_train_state(
            os.path.join(args.save_path, "train_state"), state)
        if last_step >= 0:
            # resume the epoch loop where the restored step left off —
            # otherwise a stage-3 model would replay curriculum stage 1
            # against an already-advanced schedule
            start_epoch = epoch_for_step(last_step, len(train_data),
                                         tcfg.batch_size, curriculums, tcfg.epochs)
            logger.info("Resumed from step %d (epoch %d)", last_step, start_epoch)
            if start_epoch >= tcfg.epochs:
                logger.warning(
                    "Checkpoint at step %d already covers all %d epochs; "
                    "nothing to train.", last_step, tcfg.epochs)
    return _train_loop(state, tx, const, mcfg, dcfg, tcfg, train_data,
                       valid_data, curriculums, args, logger, device,
                       start_epoch=start_epoch)


def _train_loop(state, tx, const, mcfg, dcfg, tcfg, train_data, valid_data,
                curriculums, args, logger, device, start_epoch: int = 0) -> float:
    train_step = make_train_step(mcfg, dcfg, tcfg, tx)
    eval_step = make_eval_step(mcfg, dcfg, tcfg)
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
            tb = _to_device(batch, device)
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
                                       valid_data, vbs, stage, device)
                logger.info("Epoch: %d, Step: %d/%d, Val. Loss: %.4f",
                            epoch + 1, step + 1, steps_per_epoch, val_loss)
                if val_loss < best_val:
                    best_val = val_loss
                    if args.save_model and args.save_path:
                        _save(args.save_path, state, "best_val", logger)

        trace.close()  # an epoch of fewer than 31 steps: trace what ran
        val_loss, _ = evaluate(eval_step, state.params, const, valid_data, vbs,
                               stage, device)
        logger.info("End eval of epoch %d. Val. Loss: %.4f", epoch + 1, val_loss)
        logger.info("Average loss: %.4f  Elapsed time: %s",
                    avg_loss / max(seen_steps, 1), format_time(time.time() - t1))
        if args.save_model and args.save_path:
            _save(args.save_path, state, f"epoch_{epoch + 1}", logger)

    logger.info("Training finished.")
    return val_loss


def _save(save_path: str, state: TrainState, tag: str, logger) -> None:
    """Two artifact streams like the reference's best_val_model.pth /
    epoch_{N}.pth: best-val checkpoints under train_state_best/, epoch
    checkpoints under train_state/ (which --resume reads)."""
    from mmtg_tpu_torch.checkpoint import save_train_state

    sub = "train_state_best" if tag == "best_val" else "train_state"
    save_train_state(os.path.join(save_path, sub), state.step, state)
    logger.info("Saved %s checkpoint at step %d to %s/%s", tag, state.step,
                save_path, sub)


if __name__ == "__main__":
    main()
