"""Batch-composition invariance of the decode: whether one (request, seed)
gives the same tokens whatever rows share its batch.

The JAX package promises it (``mmtg_tpu/serve.py``: a request's tokens
depend on its seed alone, not on the window it was batched into), and so does
the port's service. Two checks:

* :func:`decode_check`: one sample with one row seed, decoded by
  ``decoding.generate(..., row_seeds=...)`` alone and at each batch size in
  ``batches``, placed at the first, the middle and the last row among random
  neighbours (one call holds the three places). For each decode path it returns
  the first step whose token differs from the lone decode's (``None``: no
  step differs). The paths (:data:`PATHS`) are the service's pinned dtypes for
  its default bucket menu (bf16 weights and an int8 cache) on the per-layer
  step and the whole-step kernel, and the per-layer step with a cache of the
  model dtype.
* :func:`op_probe`: each op of the encoder (every channel kind: the default
  single-layer GRU's fused kernel, and the LSTM, RNN, 2-layer GRU and TRM
  stacks at full width from seeded weights of their own), the prefill, one
  decode step and
  the sampler given the bit-identical input for one row at each row count M,
  (the first, the middle and the last row) beside random rows; it returns,
  per op, the row counts at which that row's output differs bit for bit from
  its output alone. Ops named ``... [library]``
  are the PyTorch calls the port replaced by its batch-invariant kernels
  (:mod:`mmtg_tpu_torch.ops.matmul`, :mod:`mmtg_tpu_torch.ops.cumsum`),
  probed for the record; the others are what the port runs.

Run it on the card (``--device cpu`` to run without one; the model is the
full-size one in bf16 from a seed, random WenLan table and prompts):

    python -m mmtg_tpu_torch.tools.batch_invariance [--batches 1,8,16,32,64]
        [--length 220] [--json out.json]

It prints one JSON line: ``{"decode": {path: first differing step},
"differing_ops": {op: [M, ...]}, "ops": {...}}``, and exits 1 when a path or
an op the port runs differs.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, Optional, Sequence

import torch

SEED = 5  # the probed request's row seed
PATHS = {
    "kernel_int8": dict(attn_impl="kernel", cache_dtype="int8", weight_dtype="model"),
    "fused_int8": dict(attn_impl="fused", cache_dtype="int8", weight_dtype="model"),
    "kernel_bf16_cache": dict(attn_impl="kernel", cache_dtype="model",
                              weight_dtype="model"),
}
BATCHES = (1, 8, 16, 32, 64)
LIBRARY = " [library]"  # an op the port no longer calls, probed for the record
# the encoder channels beside the default single-layer GRU: (kind, layers)
CHANNELS = {"LSTM": ("LSTM", 1), "RNN": ("RNN", 1), "GRU2": ("GRU", 2),
            "TRM": ("TRM", 1)}


def channel_op(name: str) -> str:
    """The op probe's name of the :data:`CHANNELS` ``name`` stack."""
    kind, layers = CHANNELS[name]
    return f"encoder.{name.lower()} ({kind}, {layers} layer{'s' * (layers > 1)})"


def channel_config(mcfg, name: str):
    """``mcfg`` with both experience channels (image and text) of
    :data:`CHANNELS` ``name``."""
    import dataclasses

    kind, layers = CHANNELS[name]
    return dataclasses.replace(
        mcfg, image=dataclasses.replace(mcfg.image, type=kind, num_layers=layers),
        text=dataclasses.replace(mcfg.text, type=kind, num_layers=layers))


def random_rows(n: int, mcfg, dcfg, gen: torch.Generator, dtype, device) -> Dict:
    """``n`` synthetic prompt rows (topic ids, masks, WenLan embeddings)."""
    P, E = dcfg.topic_prompt_length, dcfg.wenlan_emb_size
    V = mcfg.gpt2.vocab_size
    return {
        "topic_ids": torch.randint(103, max(104, V - 1), (n, P), generator=gen,
                                   device=device, dtype=torch.int32),
        "tpw_attention_mask": torch.ones(n, P, dtype=torch.int32, device=device),
        "tpw_type_ids": torch.ones(n, P, dtype=torch.int32, device=device),
        "topic_emb": torch.randn(n, E, generator=gen, device=device).to(dtype),
        "img_embs": torch.randn(n, mcfg.seq_len, E, generator=gen,
                                device=device).to(dtype),
        "r_embs": torch.randn(n, mcfg.seq_len, E, generator=gen,
                              device=device).to(dtype),
    }


def _placed(sample: Dict, neighbours: Dict, B: int, places: Sequence[int]) -> Dict:
    batch = {k: v[:B].clone() for k, v in neighbours.items()}
    for p in places:
        for k in batch:
            batch[k][p] = sample[k][0]
    return batch


def _first_diff(row: torch.Tensor, ref: torch.Tensor) -> Optional[int]:
    """The first decode step (0-based) whose token differs, else None."""
    bad = (row[1:] != ref[1:]).nonzero()
    return int(bad[0, 0]) if bad.numel() else None


def decode_check(params, const, mcfg, dcfg, gcfg, sample: Dict,
                 neighbour_sets: Sequence[Dict], batches: Sequence[int] = BATCHES,
                 seed: int = 0) -> Dict:
    """``sample`` (one row) decoded with row seed :data:`SEED` alone, then at
    each B of ``batches`` at rows 0, B // 2 and B - 1 of each neighbour set
    (whose rows get seeds of their own), on the model ``mcfg`` / ``params``
    (any channel kinds: :func:`channel_config`). Returns ``{"first_diff": the
    earliest step any placement differs at, or None, "runs": [...]}``."""
    from mmtg_tpu_torch import decoding
    from mmtg_tpu_torch.ops import prng

    dev = sample["topic_ids"].device
    key = prng.PRNGKey(seed, device=dev)

    def run(batch, seeds):
        return decoding.generate(params, const, mcfg, dcfg, gcfg, batch, key,
                                 torch.tensor(seeds, dtype=torch.int64, device=dev))

    ref = run(sample, [SEED])[0]
    runs, first = [], None
    for n, neigh in enumerate(neighbour_sets):
        for B in batches:
            if B == 1:
                continue
            places = sorted({0, B // 2, B - 1})
            seeds = [1000 * (n + 1) + b for b in range(B)]
            for p in places:
                seeds[p] = SEED
            toks = run(_placed(sample, neigh, B, places), seeds)
            for p in places:
                d = _first_diff(toks[p], ref)
                runs.append(dict(neighbours=n, B=B, row=p, first_diff=d))
                if d is not None and (first is None or d < first):
                    first = d
    return dict(first_diff=first, runs=runs)


def decode_paths(params, const, mcfg, dcfg, sample, neighbour_sets,
                 batches: Sequence[int] = BATCHES, length: int = 220,
                 paths: Dict = PATHS) -> Dict:
    """:func:`decode_check` on each of ``paths`` (GenerateConfig fields)."""
    from mmtg_tpu_torch.configs import GenerateConfig

    return {name: decode_check(params, const, mcfg, dcfg,
                               GenerateConfig(length=length, **kw), sample,
                               neighbour_sets, batches)
            for name, kw in paths.items()}


# ---------------------------------------------------------------------------
# The op probe. Each op is (row shapes, function): the function takes a dict
# of inputs whose leading axis is the row count M (an axis of 1 for a
# "[T, M, ...]" input is named by a leading "T:" in its shape key) and returns
# a tensor, or a tuple of tensors, with the rows on axis 0 (or on the axis
# its input had them).


def _ops(params, mcfg, dcfg, dtype, device) -> Dict[str, tuple]:
    import torch.nn.functional as F

    from mmtg_tpu_torch.configs import ChannelConfig
    from mmtg_tpu_torch.models import gpt2
    from mmtg_tpu_torch.models.attention import alpha_attention, beta_attention
    from mmtg_tpu_torch.models.encoder import _trm_forward
    from mmtg_tpu_torch.models.mmtg import encode_experiences, project_to_gpt2
    from mmtg_tpu_torch.ops.rnn import rnn_forward
    from mmtg_tpu_torch.params import _Init, tree_to
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.ops.cumsum import row_cumsum
    from mmtg_tpu_torch.ops.layer_norm import (add_layer_norm_plain, add_layer_norm_rows,
                                               layer_norm_rows)
    from mmtg_tpu_torch.ops.matmul import batched_matmul, matmul, matmul_plain
    from mmtg_tpu_torch.ops.decode_megakernel import decode_block_fused
    from mmtg_tpu_torch.ops.fused_gru import fused_gru
    from mmtg_tpu_torch.ops.sampling import sample_next_token, top_k_sorted

    g = params["gpt2"]
    cfg = mcfg.gpt2
    p = g["h"]
    D, L, H = cfg.n_embd, cfg.n_layer, cfg.n_head
    E, Hs = dcfg.wenlan_emb_size, mcfg.topic.hidden_dim
    S, P = mcfg.seq_len, dcfg.topic_prompt_length
    V, T = cfg.vocab_size, 256
    pos = T - 21  # the last decode step's position
    eps = cfg.layer_norm_epsilon
    enc = params["encoder"]
    gru = (enc["image"]["layers"][0]
           if mcfg.image.type == "GRU" and mcfg.image.num_layers == 1 else None)

    def cache_rows(kind, layers):
        # per row: [L, T, row] cache rows and [L, T] scales (int8) or [L, T, D]
        shapes = {"k": (layers, T, D), "v": (layers, T, D)}
        if kind == "int8":
            shapes.update({"k_scale": (layers, T), "v_scale": (layers, T),
                           "mask": (T,)})
        else:
            shapes["mask"] = (T,)
        return shapes

    def cache_of(x, kind):
        # the row axis of the probe is axis 0; caches want [L, M, T, row]
        k = x["k"].transpose(0, 1).contiguous()
        v = x["v"].transpose(0, 1).contiguous()
        if kind == "int8":
            k = (k * 40).round().clamp(-127, 127).to(torch.int8)
            v = (v * 40).round().clamp(-127, 127).to(torch.int8)
            ks = (x["k_scale"].abs() * 0.01 + 1e-3).float().transpose(0, 1).contiguous()
            vs = (x["v_scale"].abs() * 0.01 + 1e-3).float().transpose(0, 1).contiguous()
            return k, v, ks, vs
        return k.to(dtype), v.to(dtype), None, None

    def mask_of(x):
        m = (x["mask"] > -2.0).to(torch.int32)  # a few masked slots a row
        return m.contiguous()

    def attention_op(kind):
        def run(x):
            k, v, ks, vs = cache_of(x, kind)
            q, kn, vn = (x[n].to(dtype).contiguous() for n in ("q", "kn", "vn"))
            mask = mask_of(x)
            if kind == "int8":
                ctx = da.decode_attention_int8_append(q, kn, vn, k, v, ks, vs, mask,
                                                      pos, 0, H)
            else:
                ctx = da.decode_attention_fp_append(q, kn, vn, k, v, mask, pos, 0, H)
            return ctx
        shapes = cache_rows(kind, 1)
        shapes.update({"q": (D,), "kn": (D,), "vn": (D,)})
        return shapes, run

    def fused_op(x):
        k, v, ks, vs = cache_of(x, "int8")
        h = x["h"].to(dtype).contiguous()
        return decode_block_fused(h, p, k, v, ks, vs, mask_of(x), pos, n_head=H,
                                  eps=eps)

    fused_shapes = cache_rows("int8", L)
    fused_shapes["h"] = (D,)

    def attn_core(bmm):
        # the prefill's attention (models/gpt2.gpt2_forward, return_kv)
        def run(x):
            q, k, v = (x[n].to(dtype) for n in ("q", "k", "v"))
            scores = bmm(q.float(), k.float().transpose(-1, -2))
            probs = torch.softmax(scores.to(dtype) * (1.0 / math.sqrt(D // H)), dim=-1)
            return bmm(probs, v)
        return run

    def prefill_op(x):
        emb = x["emb"].to(dtype)
        M = emb.shape[0]
        ones = torch.ones(M, P + 1, dtype=torch.int32, device=device)
        logits, cache = gpt2.prefill_cache(
            g, cfg, emb, torch.arange(P + 1, device=device), ones.to(torch.int64),
            ones, T, "int8")
        return logits, cache.k.transpose(0, 1), cache.k_scale.transpose(0, 1)

    def encoder_op(x):
        fused, kl = encode_experiences(params, mcfg, x["topic"].to(dtype),
                                       x["img"].to(dtype), x["txt"].to(dtype),
                                       use_kernels=True)
        return fused

    def sample_op(top_k):
        def run(x):
            logits = x["logits"].to(dtype)
            M = logits.shape[0]
            seen = (x["seen"].abs() * 2).to(torch.int16)
            keys = prng.fold_in(prng.PRNGKey(0, device=device)[None, :],
                                torch.full((M,), SEED, dtype=torch.int64, device=device))
            return sample_next_token(
                keys, logits, seen, torch.full((M,), 7, dtype=torch.int32, device=device),
                temperature=1.1, top_k=top_k, top_p=0.7, repetition_penalty=1.5,
                per_row_keys=True)
        return {"logits": (V,), "seen": (V,)}, run

    def channel_ops(name):
        # a channel stack of its own seeded weights at the repo's widths:
        # what the port runs (the kernels) and the library calls it replaced
        kind, layers = CHANNELS[name]
        tree = tree_to(_Init(7).channel(ChannelConfig(input_dim=E, hidden_dim=Hs, type=kind,
                                                      num_layers=layers)), device, dtype)
        label = channel_op(name)
        if kind == "TRM":
            def run(use):
                return lambda x: _trm_forward(tree, x["x"].to(dtype), use_kernels=use)
        else:
            def run(use):
                return lambda x: rnn_forward(tree, x["x"].to(dtype), kind,
                                             mm=matmul if use else matmul_plain)[0]
        return {label + LIBRARY: ({"T:x": (S, E)}, run(False)),
                label: ({"T:x": (S, E)}, run(True))}

    def lib(key, l=0, bias=None):  # torch.matmul (cuBLAS on the card)
        b = None if bias is None else p[bias][l]
        return lambda x: matmul_plain(x["x"].to(dtype), p[key][l], b)

    def port(key, l=0, bias=None):  # the port's batch-invariant product
        b = None if bias is None else p[bias][l]
        return lambda x: matmul(x["x"].to(dtype), p[key][l], b)

    attn_shapes = {n: (H, P + 1, D // H) for n in ("q", "k", "v")}
    ops = {
        # ---- the encoder (once a call) ------------------------------------
        "encoder.topic_fc [library]": ({"x": (E,)}, lambda x: matmul_plain(
            x["x"].to(dtype), enc["topic_fc"]["w"], enc["topic_fc"]["b"])),
        "encoder.topic_fc": ({"x": (E,)}, lambda x: matmul(
            x["x"].to(dtype), enc["topic_fc"]["w"], enc["topic_fc"]["b"])),
        "encoder.gru_input_projection [library]": ({"T:x": (S, E)}, lambda x: matmul_plain(
            x["x"].to(dtype), gru["w_ih"], gru["b_ih"])),
        "encoder.fused_gru": (
            {"T:x": (S, E)}, lambda x: fused_gru(x["x"].to(dtype), gru["w_ih"], gru["w_hh"],
                                                 gru["b_ih"], gru["b_hh"])),
        "encoder.layer_norm [library]": ({"T:x": (S, Hs)}, lambda x: gpt2.layer_norm(
            x["x"].to(dtype), params["ln_image"]["g"], params["ln_image"]["b"], 1e-5)),
        "encoder.layer_norm": ({"T:x": (S, Hs)}, lambda x: layer_norm_rows(
            x["x"].to(dtype), params["ln_image"]["g"], params["ln_image"]["b"], 1e-5)),
        "encoder.alpha_attention [library]": ({"x": (S, Hs)}, lambda x: alpha_attention(
            params["alpha_img"], mcfg, x["x"].to(dtype))[0]),
        "encoder.alpha_attention": ({"x": (S, Hs)}, lambda x: alpha_attention(
            params["alpha_img"], mcfg, x["x"].to(dtype), True)[0]),
        "encoder.beta_attention [library]": (
            {"t": (Hs,), "i": (S, Hs), "r": (S, Hs)},
            lambda x: beta_attention(params["beta"], x["t"].to(dtype), x["i"].to(dtype),
                                     x["r"].to(dtype))),
        "encoder.beta_attention": (
            {"t": (Hs,), "i": (S, Hs), "r": (S, Hs)},
            lambda x: beta_attention(params["beta"], x["t"].to(dtype), x["i"].to(dtype),
                                     x["r"].to(dtype), True)),
        "encoder (whole)": ({"topic": (E,), "img": (S, E), "txt": (S, E)}, encoder_op),
        **{k: v for name in CHANNELS for k, v in channel_ops(name).items()},
        # the TRM block's elementwise and row ops at its widths (4 heads, the
        # T x T scores' rows of 5; the MLP's 4 x 512)
        "encoder.trm softmax": ({"x": (4, S, S)}, lambda x: torch.softmax(
            x["x"].to(dtype), dim=-1)),
        "encoder.trm gelu": ({"x": (S, 4 * Hs)}, lambda x: F.gelu(
            x["x"].to(dtype), approximate="tanh")),
        # ---- the prefill (once a call; rows of P + 1 positions) -------------
        "projector (prefill rows) [library]": ({"x": (P + 1, E)}, lambda x: project_to_gpt2(
            params, x["x"].to(dtype))),
        "projector (prefill rows)": ({"x": (P + 1, E)}, lambda x: project_to_gpt2(
            params, x["x"].to(dtype), True)),
        "prefill.attention [library]": (attn_shapes, attn_core(torch.matmul)),
        "prefill.attention": (attn_shapes, attn_core(batched_matmul)),
        "prefill.qkv [library]": ({"x": (P + 1, D)}, lib("attn_w", bias="attn_b")),
        "prefill.qkv": ({"x": (P + 1, D)}, port("attn_w", bias="attn_b")),
        "prefill.attn_proj [library]": ({"x": (P + 1, D)}, lib("attn_proj_w")),
        "prefill.attn_proj": ({"x": (P + 1, D)}, port("attn_proj_w")),
        "prefill.mlp_fc [library]": ({"x": (P + 1, D)}, lib("mlp_fc_w", bias="mlp_fc_b")),
        "prefill.mlp_fc": ({"x": (P + 1, D)}, port("mlp_fc_w", bias="mlp_fc_b")),
        "prefill.mlp_proj [library]": ({"x": (P + 1, 4 * D)}, lib("mlp_proj_w")),
        "prefill.mlp_proj": ({"x": (P + 1, 4 * D)}, port("mlp_proj_w")),
        "prefill (whole)": ({"emb": (P + 1, D)}, prefill_op),
        # ---- one decode step ------------------------------------------------
        "projector (step) [library]": ({"x": (E,)}, lambda x: project_to_gpt2(
            params, x["x"].to(dtype))),
        "projector (step)": ({"x": (E,)}, lambda x: project_to_gpt2(
            params, x["x"].to(dtype), True)),
        "layer_norm [library]": ({"x": (D,)}, lambda x: gpt2.layer_norm(
            x["x"].to(dtype), p["ln1_g"][0], p["ln1_b"][0], eps)),
        "layer_norm": ({"x": (D,)}, lambda x: layer_norm_rows(
            x["x"].to(dtype), p["ln1_g"][0], p["ln1_b"][0], eps)),
        # a residual h + y + bias and the LayerNorm after it (ln2, ln1 of the
        # next layer, the final one): the eager adds and ops, the one launch
        "add_layer_norm [library]": ({"h": (D,), "y": (D,)}, lambda x: add_layer_norm_plain(
            x["h"].to(dtype), x["y"].to(dtype), p["attn_proj_b"][0], p["ln2_g"][0],
            p["ln2_b"][0], eps)),
        "add_layer_norm": ({"h": (D,), "y": (D,)}, lambda x: add_layer_norm_rows(
            x["h"].to(dtype), x["y"].to(dtype), p["attn_proj_b"][0], p["ln2_g"][0],
            p["ln2_b"][0], eps)),
        "decode.qkv [library]": ({"x": (D,)}, lib("attn_w")),
        "decode.qkv": ({"x": (D,)}, port("attn_w")),
        "decode.attn_proj [library]": ({"x": (D,)}, lib("attn_proj_w")),
        "decode.attn_proj": ({"x": (D,)}, port("attn_proj_w")),
        "decode.mlp_fc [library]": ({"x": (D,)}, lib("mlp_fc_w")),
        "decode.mlp_fc": ({"x": (D,)}, port("mlp_fc_w")),
        "decode.mlp_proj [library]": ({"x": (4 * D,)}, lib("mlp_proj_w")),
        "decode.mlp_proj": ({"x": (4 * D,)}, port("mlp_proj_w")),
        "decode_attention_int8_append": attention_op("int8"),
        "decode_attention_fp_append": attention_op("fp"),
        "decode_block_fused": (fused_shapes, fused_op),
        "lm_head [library]": ({"x": (D,)}, lambda x: x["x"].to(dtype) @ g["wte"].T),
        "lm_head": ({"x": (D,)}, lambda x: matmul(x["x"].to(dtype), g["wte"].T)),
        # ---- sampling --------------------------------------------------------
        "sampling.softmax": ({"x": (V,)}, lambda x: torch.softmax(x["x"].to(dtype), -1)),
        "sampling.cumsum [library]": ({"x": (V,)}, lambda x: torch.cumsum(
            torch.softmax(x["x"].to(dtype), -1), -1)),
        "sampling.cumsum": ({"x": (V,)}, lambda x: row_cumsum(
            torch.softmax(x["x"].to(dtype), -1))),
        "sampling.topk": ({"x": (V,)}, lambda x: torch.topk(x["x"].to(dtype), 10, -1)),
        # logits on a coarse grid: the top 10 hold ties, as bf16 logits often do
        "sampling.topk with ties [library]": ({"x": (V,)}, lambda x: torch.topk(
            _ties(x["x"], dtype), 10, -1)),
        "sampling.top_k_sorted with ties": ({"x": (V,)}, lambda x: top_k_sorted(
            _ties(x["x"], dtype), 10)),
        "sampling.sort": ({"x": (V,)}, lambda x: torch.sort(
            x["x"].to(dtype), dim=-1, descending=True, stable=True)),
        "sample_next_token (top-k 10, top-p 0.7)": sample_op(10),
        "sample_next_token (top-p 0.7 alone)": sample_op(0),
    }
    if gru is None:
        for k in ("encoder.gru_input_projection [library]", "encoder.fused_gru"):
            ops.pop(k)
    return ops


def _ties(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` on a grid of 1/4: many equal values near the top of a row."""
    return (x * 4).round().div(4).to(dtype)


def _inputs(shapes: Dict, M: int, row: int, fixed: Dict, gen, device) -> Dict:
    """Random inputs of M rows with ``fixed`` at row ``row``."""
    out = {}
    for name, shape in shapes.items():
        steps = name.startswith("T:")
        key = name[2:] if steps else name
        if steps:  # [T, M, ...]
            x = torch.randn((shape[0], M) + tuple(shape[1:]), generator=gen, device=device)
            x[:, row] = fixed[name]
        else:
            x = torch.randn((M,) + tuple(shape), generator=gen, device=device)
            x[row] = fixed[name]
        out[key] = x
    return out


def _row_of(y, shapes: Dict, row: int):
    steps = any(n.startswith("T:") for n in shapes)
    ys = y if isinstance(y, tuple) else (y,)
    return tuple((t[:, row] if steps else t[row]).clone() for t in ys)


def op_probe(params, mcfg, dcfg, Ms: Sequence[int] = BATCHES,
             dtype=torch.bfloat16, seed: int = 0, library: bool = True,
             prefix: str = "") -> Dict:
    """Each op of :func:`_ops` (without ``library`` the port's alone; with
    ``prefix`` those whose name starts with it) on one fixed row at each M of
    ``Ms`` (at rows 0, M // 2 and M - 1 among random rows). Returns ``{op:
    {"differs": [M, ...], "max_abs": largest difference from the row
    alone}}``."""
    device = params["gpt2"]["wte"].device
    found = {}
    with torch.no_grad():
        for name, (shapes, fn) in _ops(params, mcfg, dcfg, dtype, device).items():
            if (not library and name.endswith(LIBRARY)) or not name.startswith(prefix):
                continue
            gen = torch.Generator(device=device).manual_seed(seed)
            fixed = {n: torch.randn(s, generator=gen, device=device)
                     for n, s in shapes.items()}
            ref = _row_of(fn(_inputs(shapes, 1, 0, fixed, gen, device)), shapes, 0)
            differs, worst = [], 0.0
            for M in Ms:
                if M == 1:
                    continue
                bad = False
                for row in sorted({0, M // 2, M - 1}):
                    got = _row_of(fn(_inputs(shapes, M, row, fixed, gen, device)),
                                  shapes, row)
                    for a, b in zip(got, ref):
                        if not torch.equal(a, b):
                            bad = True
                            if a.is_floating_point():
                                worst = max(worst, float((a.float() - b.float()).abs()
                                                         .max()))
                if bad:
                    differs.append(M)
            found[name] = dict(differs=differs, max_abs=worst)
    return found


def full_size_model(seed: int = 0, dtype=torch.bfloat16, device="cuda", mcfg=None,
                    dcfg=None):
    """The repo's model (or ``mcfg`` / ``dcfg``) with seeded weights in
    ``dtype``, and a random WenLan table: (mcfg, dcfg, params, const)."""
    from mmtg_tpu_torch.configs import DataConfig, ModelConfig
    from mmtg_tpu_torch.params import init_params

    mcfg = mcfg or ModelConfig()
    dcfg = dcfg or DataConfig()
    params = init_params(mcfg, seed=seed, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    table = torch.randn(mcfg.gpt2.vocab_size, dcfg.wenlan_emb_size, generator=gen,
                        device=device).to(dtype)
    return mcfg, dcfg, params, {"wenlan_table": table}


def run(args, mcfg=None, dcfg=None, model=None) -> Dict:
    """The two checks at ``args``' sizes; ``model``: (mcfg, dcfg, params,
    const) already built (``mcfg`` may name any channels:
    :func:`channel_config`)."""
    dtype = getattr(torch, args.dtype)
    if model is None:
        model = full_size_model(args.seed, dtype, args.device, mcfg, dcfg)
    mcfg, dcfg, params, const = model
    batches = tuple(int(b) for b in str(args.batches).split(","))
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 2)
    sample = random_rows(1, mcfg, dcfg, gen, dtype, args.device)
    neigh = [random_rows(max(batches), mcfg, dcfg, gen, dtype, args.device)]
    res = decode_paths(params, const, mcfg, dcfg, sample, neigh, batches, args.length)
    from mmtg_tpu_torch.params import tree_to

    return {"decode": {k: v["first_diff"] for k, v in res.items()},
            "decode_runs": {k: v["runs"] for k, v in res.items()},
            "ops": op_probe(params, mcfg, dcfg, batches, dtype, args.seed),
            # f32 shows any change of summation order (bf16 hides most of
            # them behind its rounding, not all)
            "ops_f32": op_probe(tree_to(params, dtype=torch.float32), mcfg, dcfg,
                                batches, torch.float32, args.seed)}


def differing(result: Dict) -> Dict:
    """What differs: ``{"decode": {path: step}, "ops": {op: [M, ...]}}``
    holding only the paths and the port's ops that do, in bf16 and (``"op
    (f32)"``) in f32 (the ``[library]`` ops are the calls the port replaced,
    probed for the record)."""
    ops = {k: v["differs"] for k, v in result.get("ops", {}).items()
           if v["differs"] and not k.endswith(LIBRARY)}
    ops.update({f"{k} (f32)": v["differs"] for k, v in result.get("ops_f32", {}).items()
                if v["differs"] and not k.endswith(LIBRARY)})
    return {"decode": {k: v for k, v in result.get("decode", {}).items()
                       if v is not None}, "ops": ops}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--length", type=int, default=220)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="also write the result here")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("batch_invariance: no CUDA device (--device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    out = run(args)
    bad = differing(out)
    line = json.dumps({"decode": out["decode"], "differing_ops": bad["ops"],
                       "ops": out["ops"], "ops_f32": out["ops_f32"]})
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 1 if bad["decode"] or bad["ops"] else 0


if __name__ == "__main__":
    sys.exit(main())
