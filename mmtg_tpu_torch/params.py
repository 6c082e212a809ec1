"""Parameter trees for the port: the bridge from / to the JAX package's
pytree (parameters and AdamW moments), a seeded initializer for machines
without JAX, and the small tree helpers the trainer uses.

The tree is the JAX package's own (``mmtg_tpu.models.mmtg.init_mmtg_params``):
nested dicts (and the GRU ``layers`` list) of tensors, stacked ``[L, ...]``
GPT-2 layers, ``x @ W`` weights (``w_ih`` is ``[in, 3H]``). So the bridge is
a copy, leaf for leaf.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from mmtg_tpu_torch.configs import ModelConfig


def from_jax_numpy(tree: Any, device="cpu", dtype: torch.dtype | None = None):
    """A pytree of numpy (or JAX) arrays → the same tree of torch tensors on
    ``device``; floating leaves are cast to ``dtype`` when given. bfloat16
    leaves arrive through float32 (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_numpy(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree: Any):
    """A tree of torch tensors → the same tree of numpy arrays on the host
    (bfloat16 leaves come back as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class _Init:
    """Draws from one CPU ``torch.Generator`` (device-independent bits)."""

    def __init__(self, seed: int):
        self.g = torch.Generator().manual_seed(seed)

    def normal(self, shape, std):
        return torch.randn(shape, generator=self.g) * std

    def uniform(self, shape, bound):
        return (torch.rand(shape, generator=self.g) * 2.0 - 1.0) * bound

    def linear(self, in_dim, out_dim, xavier=False):
        """torch ``nn.Linear`` default U(-1/√in, 1/√in); ``xavier`` gives
        the reference's Xavier-normal weight."""
        bound = 1.0 / math.sqrt(in_dim)
        if xavier:
            w = self.normal((in_dim, out_dim), math.sqrt(2.0 / (in_dim + out_dim)))
        else:
            w = self.uniform((in_dim, out_dim), bound)
        return {"w": w, "b": self.uniform((out_dim,), bound)}

    def orthogonal(self, rows, cols):
        """torch ``init.orthogonal_`` on ``[rows, cols]``, returned
        transposed to the ``[cols, rows]`` compute layout."""
        n, m = max(rows, cols), min(rows, cols)
        q, r = torch.linalg.qr(torch.randn((n, m), generator=self.g))
        q = q * torch.sign(torch.diagonal(r))
        q = q[:rows, :cols] if rows >= cols else q.T[:rows, :cols]
        return q.T.contiguous()

    def gru(self, input_dim, hidden, num_layers):
        """torch-default GRU init with the reference's layer-0 overrides
        (Xavier-normal ``w_ih``, orthogonal ``w_hh``)."""
        bound = 1.0 / math.sqrt(hidden)
        layers = []
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else hidden
            if layer == 0:
                w_ih = self.normal((in_dim, 3 * hidden),
                                   math.sqrt(2.0 / (3 * hidden + in_dim)))
                w_hh = self.orthogonal(3 * hidden, hidden)
            else:
                w_ih = self.uniform((in_dim, 3 * hidden), bound)
                w_hh = self.uniform((hidden, 3 * hidden), bound)
            layers.append({"w_ih": w_ih, "w_hh": w_hh,
                           "b_ih": self.uniform((3 * hidden,), bound),
                           "b_hh": self.uniform((3 * hidden,), bound)})
        return {"layers": layers}


def _gpt2_tree(init: _Init, g) -> Dict:
    D, L, std = g.n_embd, g.n_layer, g.initializer_range
    proj_std = std / math.sqrt(2 * L)
    return {
        "wte": init.normal((g.vocab_size, D), std),
        "wpe": init.normal((g.n_positions, D), std),
        "h": {
            "ln1_g": torch.ones(L, D),
            "ln1_b": torch.zeros(L, D),
            "attn_w": init.normal((L, D, 3 * D), std),
            "attn_b": torch.zeros(L, 3 * D),
            "attn_proj_w": init.normal((L, D, D), proj_std),
            "attn_proj_b": torch.zeros(L, D),
            "ln2_g": torch.ones(L, D),
            "ln2_b": torch.zeros(L, D),
            "mlp_fc_w": init.normal((L, D, 4 * D), std),
            "mlp_fc_b": torch.zeros(L, 4 * D),
            "mlp_proj_w": init.normal((L, 4 * D, D), proj_std),
            "mlp_proj_b": torch.zeros(L, D),
        },
        "lnf_g": torch.ones(D),
        "lnf_b": torch.zeros(D),
    }


def init_gpt2_params(cfg, seed: int = 0, dtype: torch.dtype = torch.float32,
                     device="cpu") -> Dict:
    """Seeded random GPT-2 parameters alone (the ``"gpt2"`` subtree of
    :func:`init_params`), for the phase-1 LM pretraining."""
    return tree_to(_gpt2_tree(_Init(seed), cfg), device, dtype)


def init_params(mcfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32, device="cpu") -> Dict:
    """Seeded random parameters with the shapes and distributions of
    ``mmtg_tpu.models.mmtg.init_mmtg_params`` (not its bits: the draws come
    from a ``torch.Generator``). GRU channels only."""
    for ch in (mcfg.image, mcfg.text):
        if ch.type != "GRU":
            raise NotImplementedError(f"channel type {ch.type!r} is not ported")
    init = _Init(seed)
    H = mcfg.topic.hidden_dim
    ln = lambda n: {"g": torch.ones(n), "b": torch.zeros(n)}  # noqa: E731
    beta_steps = [init.linear(H, mcfg.mm_att_dim) for _ in range(mcfg.seq_len)]
    tree = {
        "encoder": {
            "topic_fc": init.linear(mcfg.topic.input_dim, H, xavier=True),
            "image": init.gru(mcfg.image.input_dim, mcfg.image.hidden_dim,
                              mcfg.image.num_layers),
            "text": init.gru(mcfg.text.input_dim, mcfg.text.hidden_dim,
                             mcfg.text.num_layers),
        },
        "ln_topic": ln(H),
        "ln_image": ln(H),
        "ln_text": ln(H),
        "alpha_img": {k: init.linear(mcfg.self_att_hidden_size,
                                     mcfg.self_att_hidden_size)
                      for k in ("query", "key", "value")},
        "alpha_text": {k: init.linear(mcfg.self_att_hidden_size,
                                      mcfg.self_att_hidden_size)
                       for k in ("query", "key", "value")},
        "beta": {
            "att_w": torch.stack([p["w"] for p in beta_steps]),
            "att_b": torch.stack([p["b"] for p in beta_steps]),
            "out": init.linear(H, mcfg.mm_att_out_dim),
        },
        "projector1": init.linear(mcfg.mm_att_out_dim, 512),
        "projector2": init.linear(512, mcfg.gpt2.n_embd),
        "gpt2": _gpt2_tree(init, mcfg.gpt2),
    }
    return tree_to(tree, device, dtype)


def tree_map(fn, tree: Any, *rest: Any):
    """``fn`` over the leaves of one tree (and of others of its shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def adam_state_from_numpy(mu: Any, nu: Any, count, device="cpu") -> Dict:
    """AdamW moments as numpy trees (``optax``'s ``ScaleByAdamState`` ``mu``
    / ``nu`` / ``count``) → the port's optimizer state
    (:class:`mmtg_tpu_torch.train.AdamW`)."""
    return {"count": torch.tensor(int(count), dtype=torch.int64, device=device),
            "mu": from_jax_numpy(mu, device, torch.float32),
            "nu": from_jax_numpy(nu, device, torch.float32)}


def adam_state_to_numpy(opt_state: Dict):
    """The port's optimizer state → ``(mu, nu, count)`` as numpy trees and
    an int (inverse of :func:`adam_state_from_numpy`)."""
    return (to_numpy(opt_state["mu"]), to_numpy(opt_state["nu"]),
            int(opt_state["count"]))


def tree_to(tree: Any, device=None, dtype: torch.dtype | None = None):
    """Move (and optionally cast) every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)
