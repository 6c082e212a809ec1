"""The plain reference of a training step: the rating-conditioned
sequence unlikelihood loss with the curriculum's sample weights, plus
``alpha`` times the alpha attention's KL; its gradient; clipping by the
global norm; AdamW with a linear warm-up and decay of the rate.

Rows run in blocks (the loss is a weighted mean over rows, so the blocks'
gradients add up to the batch's), in float32, or in float8 products for
the control. Dropout masks are worked out from the step's seeds
(:class:`~h100bench.reference.model.Dropout`).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from h100bench.reference import model as ref

NEAR_0 = 1e-10


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a/b/0/c": leaf}`` of a parameter tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def sample_weights(ratings: torch.Tensor, stage: int) -> torch.Tensor:
    """Stage 1 trains on ratings under 2 or over 4, stage 2 on all but 3,
    stage 3 on every row."""
    if stage == 1:
        return ((ratings < 2) | (ratings > 4)).float()
    if stage == 2:
        return (ratings != 3).float()
    return torch.ones_like(ratings, dtype=torch.float32)


def row_objective(logits, kl, targets, ratings, stage: int, prompt: int,
                  alpha: float):
    """Per row: the sequence-level unlikelihood of its mean token
    cross-entropy over the 220 shifted target positions (the label is 1
    where the rating is over 4 in stage 1, over 3 later), plus ``alpha``
    times its KL."""
    y = ((ratings > 4) if stage == 1 else (ratings > 3)).float()
    logp = torch.log_softmax(logits[:, prompt:-1].float(), -1)
    nll = -torch.gather(logp, -1, targets[:, 1:].long()[..., None])[..., 0]
    p = torch.exp(-nll.mean(-1))
    ul = -y * torch.log(p + NEAR_0) - (1.0 - y) * torch.log(1.0 - p + NEAR_0)
    return ul, alpha * kl


def rate(opt: dict, count: int) -> float:
    """Linear warm-up over ``warmup`` updates from 0, then a linear decay to
    0 at ``total``; update ``count`` (from 0) reads the rate at ``count``."""
    warm = max(opt["warmup_steps"], 1)
    decay = max(opt["total_steps"] - opt["warmup_steps"], 1)
    if count < warm:
        return opt["lr"] * count / warm
    return opt["lr"] * (1.0 - min(max(count - warm, 0), decay) / decay)


class Steps:
    """The reference's training run from the benchmark's initial weights:
    ``step(batch, draws)`` makes one step and returns its objective."""

    def __init__(self, params: Dict, model: dict, data: dict, table, opt: dict,
                 prec: str = "f32", block: int = 32):
        self.p = {k: v.detach().clone().requires_grad_(True)
                  for k, v in leaves(params).items()}
        self.tree = params
        self.model, self.data, self.table, self.opt = model, data, table, opt
        self.prec, self.block = prec, block
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.first_grads: Dict[str, torch.Tensor] = {}

    def _tree(self):
        def build(t, prefix=""):
            if isinstance(t, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in t.items()}
            if isinstance(t, list):
                return [build(v, f"{prefix}{i}/") for i, v in enumerate(t)]
            return self.p[prefix[:-1]]
        return build(self.tree)

    def step(self, batch: Dict, stage: int, draws: List[int]) -> float:
        B, Tt = batch["targets"].shape
        P = self.data["topic_prompt_length"]
        T = P + Tt
        g2 = self.model["gpt2"]
        drop = ref.Dropout(draws, g2["resid_pdrop"], B, T, -(-T // 128) * 128,
                           g2["n_embd"], batch["targets"].device)
        w = sample_weights(batch["rating"], stage) * batch["sample_mask"]
        denom = w.sum().clamp_min(1.0)
        tree = self._tree()
        grads = {k: torch.zeros_like(v) for k, v in self.p.items()}
        total = 0.0
        for lo in range(0, B, self.block):
            rows = range(lo, min(lo + self.block, B))
            part = {k: v[lo:rows.stop] for k, v in batch.items()}
            logits, kl = ref.forward(tree, self.model, self.data, self.table,
                                     part, part["targets"],
                                     part["attention_mask"], self.prec, drop,
                                     rows)
            ul, akl = row_objective(logits, kl, part["targets"], part["rating"],
                                    stage, P, self.opt["alpha"])
            wr = w[lo:rows.stop]
            obj = ((ul * wr).sum() + (akl * wr).sum()) / denom
            gs = torch.autograd.grad(obj, list(self.p.values()),
                                     allow_unused=True)
            for (k, acc), g in zip(grads.items(), gs):
                if g is not None:
                    acc.add_(g)
            total += float(obj.detach())
            del logits, kl, ul, akl, obj, gs
        self._update(grads, bool(w.sum() > 0))
        return total

    @torch.no_grad()
    def _update(self, grads: Dict, keep: bool) -> None:
        o = self.opt
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        clip = 1.0 if float(norm) < o["clip_norm"] else o["clip_norm"] / float(norm)
        if not keep:
            return
        lr = rate(o, self.count)
        t = self.count + 1
        c1, c2 = 1.0 - o["b1"] ** t, 1.0 - o["b2"] ** t
        for k, p in self.p.items():
            g = grads[k] * clip
            if self.count == 0:
                self.first_grads[k] = g.clone()
            self.mu[k].mul_(o["b1"]).add_((1.0 - o["b1"]) * g)
            self.nu[k].mul_(o["b2"]).add_((1.0 - o["b2"]) * g.square())
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + o["eps"])
            if o["weight_decay"]:
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
        self.count += 1
