"""Everything a run makes from its ``--seed``: weights, the WenLan / CLIP
table and the inputs, on the device, in a few large draws.

The tree has the layout the port takes (:mod:`mmtg_tpu_torch.params`:
nested dicts, stacked ``[L, ...]`` GPT-2 layers, ``x @ W`` weights), with
the distributions of its initializer (N(0, 0.02) GPT-2 weights, zero
biases, unit LayerNorm gains, U(-1/sqrt(in), 1/sqrt(in)) linears), but the
values come from two draws of a ``torch.Generator`` on the device: one
normal and one uniform buffer, cut into leaves. The same seed on the same
device gives the same bits, so the plain reference can make the weights
again after the program's state is freed.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed: any whole
    number, negative or past 64 bits, maps to a valid generator seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _leaf_specs(model: dict) -> List[Tuple[tuple, tuple, str, float]]:
    """``(path, shape, kind, scale)`` of every leaf; ``kind`` is ``normal``
    (std ``scale``), ``uniform`` (bound ``scale``) or ``const``."""
    g = model["gpt2"]
    D, L, V, Pn = g["n_embd"], g["n_layer"], g["vocab_size"], g["n_positions"]
    std = g["initializer_range"]
    proj_std = std / math.sqrt(2 * L)
    H = model["topic"]["hidden_dim"]
    S = model["self_att_hidden_size"]
    out = []

    def linear(path, i, o, xavier=False):
        b = 1.0 / math.sqrt(i)
        if xavier:
            out.append((path + ("w",), (i, o), "normal", math.sqrt(2.0 / (i + o))))
        else:
            out.append((path + ("w",), (i, o), "uniform", b))
        out.append((path + ("b",), (o,), "uniform", b))

    def ln(path, n):
        out.append((path + ("g",), (n,), "const", 1.0))
        out.append((path + ("b",), (n,), "const", 0.0))

    linear(("encoder", "topic_fc"), model["topic"]["input_dim"], H, xavier=True)
    for name in ("image", "text"):
        ch = model[name]
        if ch["type"] != "GRU" or ch["num_layers"] != 1:
            raise ValueError(f"{name} channel {ch['type']} x{ch['num_layers']}: "
                             "the harness makes single-layer GRU channels")
        G = 3 * ch["hidden_dim"]
        bnd = 1.0 / math.sqrt(ch["hidden_dim"])
        p = ("encoder", name, "layers", 0)
        out.append((p + ("w_ih",), (ch["input_dim"], G), "normal",
                    math.sqrt(2.0 / (G + ch["input_dim"]))))
        out.append((p + ("w_hh",), (ch["hidden_dim"], G), "normal", bnd))
        out.append((p + ("b_ih",), (G,), "uniform", bnd))
        out.append((p + ("b_hh",), (G,), "uniform", bnd))
    for name in ("ln_topic", "ln_image", "ln_text"):
        ln((name,), H)
    for a in ("alpha_img", "alpha_text"):
        for k in ("query", "key", "value"):
            linear((a, k), S, S)
    T, k = model["seq_len"], model["mm_att_dim"]
    bnd = 1.0 / math.sqrt(H)
    out.append((("beta", "att_w"), (T, H, k), "uniform", bnd))
    out.append((("beta", "att_b"), (T, k), "uniform", bnd))
    linear(("beta", "out"), H, model["mm_att_out_dim"])
    linear(("projector1",), model["mm_att_out_dim"], 512)
    linear(("projector2",), 512, D)
    gp = ("gpt2",)
    out.append((gp + ("wte",), (V, D), "normal", std))
    out.append((gp + ("wpe",), (Pn, D), "normal", std))
    h = gp + ("h",)
    for name, shape, kind, scale in (
            ("ln1_g", (L, D), "const", 1.0), ("ln1_b", (L, D), "const", 0.0),
            ("attn_w", (L, D, 3 * D), "normal", std),
            ("attn_b", (L, 3 * D), "const", 0.0),
            ("attn_proj_w", (L, D, D), "normal", proj_std),
            ("attn_proj_b", (L, D), "const", 0.0),
            ("ln2_g", (L, D), "const", 1.0), ("ln2_b", (L, D), "const", 0.0),
            ("mlp_fc_w", (L, D, 4 * D), "normal", std),
            ("mlp_fc_b", (L, 4 * D), "const", 0.0),
            ("mlp_proj_w", (L, 4 * D, D), "normal", proj_std),
            ("mlp_proj_b", (L, D), "const", 0.0)):
        out.append((h + (name,), shape, kind, scale))
    out.append((gp + ("lnf_g",), (D,), "const", 1.0))
    out.append((gp + ("lnf_b",), (D,), "const", 0.0))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(nxt, int):
            node = node.setdefault(k, [])
            while len(node) <= nxt:
                node.append({})
        elif isinstance(k, int):
            node = node[k]
        else:
            node = node.setdefault(k, {})
    node[path[-1]] = value


def make_weights(model: dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """The parameter tree of ``model`` (a configuration file's ``model``
    group), made on ``device`` in ``dtype`` from two draws."""
    specs = _leaf_specs(model)
    n = {kind: sum(math.prod(s) for _, s, k, _ in specs if k == kind)
         for kind in ("normal", "uniform")}
    gen = generator(seed, "weights", device)
    normal = torch.randn(n["normal"], generator=gen, device=device)
    uniform = torch.rand(n["uniform"], generator=gen, device=device)
    at = {"normal": 0, "uniform": 0}
    tree: dict = {}
    for path, shape, kind, scale in specs:
        if kind == "const":
            leaf = torch.full(shape, scale, dtype=dtype, device=device)
        else:
            m = math.prod(shape)
            raw = (normal if kind == "normal" else uniform)[at[kind]:at[kind] + m]
            at[kind] += m
            if kind == "uniform":
                raw = raw * 2.0 - 1.0
            leaf = (raw * scale).view(shape).to(dtype)
        _put(tree, path, leaf)
    return tree


def make_table(vocab: int, width: int, seed: int, device,
               dtype: torch.dtype) -> torch.Tensor:
    """The token embedding table (WenLan 2048-d, or CLIP 512-d) ``[vocab,
    width]``: N(0, 1), one draw."""
    gen = generator(seed, "table", device)
    return torch.randn(vocab, width, generator=gen, device=device).to(dtype)


def _prompt(B: int, data: dict, model: dict, gen, device, dtype) -> Dict:
    P, E = data["topic_prompt_length"], data["wenlan_emb_size"]
    V, T = model["gpt2"]["vocab_size"], model["seq_len"]
    return {
        # ids from 104 up: no special token ([PAD] ... [MASK] are 0-103)
        "topic_ids": torch.randint(104, V, (B, P), generator=gen,
                                   device=device, dtype=torch.int32),
        "tpw_attention_mask": torch.ones(B, P, dtype=torch.int32, device=device),
        "tpw_type_ids": torch.ones(B, P, dtype=torch.int32, device=device),
        "topic_emb": torch.randn(B, E, generator=gen, device=device).to(dtype),
        "img_embs": torch.randn(B, T, E, generator=gen, device=device).to(dtype),
        "r_embs": torch.randn(B, T, E, generator=gen, device=device).to(dtype),
    }


def generate_batch(B: int, data: dict, model: dict, seed: int, index: int,
                   device, dtype) -> Dict:
    """Prompt batch ``index`` of a generate run: topic prompt, its mask and
    type ids, and the topic / image / text embeddings."""
    return _prompt(B, data, model, generator(seed, f"prompts{index}", device),
                   device, dtype)


def train_batch(B: int, data: dict, model: dict, seed: int, index: int,
                device) -> Dict:
    """Train batch ``index``: a prompt batch plus 221 target ids, their
    mask and type ids, and a rating a row (1-5)."""
    gen = generator(seed, f"rows{index}", device)
    b = _prompt(B, data, model, gen, device, torch.float32)
    Tt = data["max_seq_length"] + 1
    V = model["gpt2"]["vocab_size"]
    b["targets"] = torch.randint(104, V, (B, Tt), generator=gen, device=device,
                                 dtype=torch.int32)
    b["attention_mask"] = torch.ones(B, Tt, dtype=torch.int32, device=device)
    b["type_ids"] = torch.randint(0, 5, (B, Tt), generator=gen, device=device,
                                  dtype=torch.int32)
    b["rating"] = torch.randint(1, 6, (B,), generator=gen,
                                device=device).to(torch.float32)
    b["sample_mask"] = torch.ones(B, dtype=torch.float32, device=device)
    return b
