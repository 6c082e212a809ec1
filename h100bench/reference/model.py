"""The plain reference of the MMTG model: experience encoder, alpha and
beta attention, the fused windows, the projector, and the GPT-2 decoder
with its tied LM head, written from the model's equations in plain PyTorch.

It imports nothing of the program. It reads the weight tree the benchmark
made (and makes again from the seed), computes in float32 with TF32 off,
and takes no cache: every position is computed from the whole prefix.
``prec="fp8"`` rounds both operands of every product (the dense ones and
the attention's) to float8 e4m3 (a scale a tensor, from its largest
magnitude) in the forward and in the backward: the control that must come
out not correct.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

PAD, START, EOS, UNK, SEP = 0, 1, 2, 100, 102
NEG_INF = -1e30
FP8_MAX = 448.0


def set_exact_float32() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Product(torch.autograd.Function):
    """``x @ w`` with both operands rounded to float8, and the two products
    of the backward likewise."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _fp8(x) @ _fp8(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq = _fp8(g)
        dx = gq @ _fp8(w).transpose(-1, -2)
        if w.dim() == 2:
            dw = _fp8(x).reshape(-1, x.shape[-1]).T @ gq.reshape(-1, g.shape[-1])
        else:
            dw = _fp8(x).transpose(-1, -2) @ gq
        return dx, dw.reshape(w.shape)


def product(x, w, b=None, prec: str = "f32"):
    """``x @ w (+ b)`` in float32, or with float8 operands."""
    y = _Fp8Product.apply(x, w) if prec == "fp8" else x @ w
    return y if b is None else y + b


def layer_norm(x, g, b, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))


def step_priors(T: int, device) -> torch.Tensor:
    """``prior[i, j]`` proportional to ``exp(-(j - i)^2 / 2)``, rows summing
    to 1: the Gaussian step prior of the alpha attention's KL."""
    i = torch.arange(T, dtype=torch.float64)
    t = torch.exp(-0.5 * (i[None, :] - i[:, None]) ** 2)
    return (t / t.sum(1, keepdim=True)).to(device, torch.float32)


def gru(x, p, prec):
    """One GRU layer (gates r, z, n; the hidden bias inside the reset
    product) over ``x`` ``[B, T, in]`` → ``[B, T, H]``."""
    B, T, _ = x.shape
    H = p["w_hh"].shape[0]
    xp = product(x, p["w_ih"], p["b_ih"], prec)
    h = torch.zeros(B, H, dtype=x.dtype, device=x.device)
    outs = []
    for t in range(T):
        xr, xz, xn = xp[:, t].split(H, -1)
        hr, hz, hn = product(h, p["w_hh"], p["b_hh"], prec).split(H, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, 1)


def alpha_attention(p, x, n_head: int, prec):
    """Self-attention over one modality's steps ``[B, T, H]`` → (context,
    per-row KL(prior || attention) summed over heads, meaned over steps)."""
    B, T, H = x.shape
    hd = H // n_head
    q, k, v = (product(x, p[n]["w"], p[n]["b"], prec)
               .view(B, T, n_head, hd).transpose(1, 2)
               for n in ("query", "key", "value"))
    probs = torch.softmax(product(q, k.transpose(-1, -2), None, prec)
                          / math.sqrt(hd), -1)
    prior = step_priors(T, x.device)
    kl = (prior * (torch.log(prior) - torch.log(probs))).sum((1, 2, 3)) / T
    return product(probs, v, None, prec).transpose(1, 2).reshape(B, T, H), kl


def encode(p, model: dict, topic, img, txt, prec="f32"):
    """``topic`` ``[B, E]``, ``img`` / ``txt`` ``[B, T, E]`` → (fused
    windows ``[B, T, out]``, KL ``[B]``)."""
    e = p["encoder"]
    heads = model["self_att_heads"]
    t = layer_norm(product(topic, e["topic_fc"]["w"], e["topic_fc"]["b"], prec),
                   p["ln_topic"]["g"], p["ln_topic"]["b"])
    i = layer_norm(gru(img, e["image"]["layers"][0], prec),
                   p["ln_image"]["g"], p["ln_image"]["b"])
    x = layer_norm(gru(txt, e["text"]["layers"][0], prec),
                   p["ln_text"]["g"], p["ln_text"]["b"])
    ic, ikl = alpha_attention(p["alpha_img"], i, heads, prec)
    xc, xkl = alpha_attention(p["alpha_text"], x, heads, prec)
    B, T, H = ic.shape
    states = torch.stack([t[:, None].expand(B, T, H), ic, xc], 2)  # [B,T,3,H]
    bt = p["beta"]
    scores = torch.einsum("btch,th->btc", states, bt["att_w"][..., 0]) \
        + bt["att_b"][None, :, 0:1]
    mix = torch.softmax(scores, -1)
    fused = torch.einsum("btc,btch->bth", mix, states)
    return product(fused, bt["out"]["w"], bt["out"]["b"], prec), ikl + xkl


def type_ids(tokens: torch.Tensor, frame: int = 22, n_sent: int = 10,
             content: int = 20) -> torch.Tensor:
    """Type ids of target tokens ``[B, K]`` (position 0 = [#START#]): the
    content slots of sentence pair p get p + 1, pair 4 gets 1; frame slots,
    [PAD] and anything past the tenth sentence get 0."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    r, sent = pos % frame, pos // frame
    pair = sent // 2
    tid = torch.where(pair == 4, torch.ones_like(pair), pair + 1)
    keep = (r >= 1) & (r <= content) & (sent < n_sent) & (tokens != PAD)
    return torch.where(keep, tid, torch.zeros_like(tid))


def decoder_inputs(p, table, fused, topic_ids, targets, window: int = 44,
                   prec="f32"):
    """[topic prompt | targets] → the projected GPT-2 input embeddings:
    each token's table row, plus on target position ``j`` the fused window
    ``j // 44`` while there is one, through 2048 → 512 → tanh → 768."""
    T = fused.shape[1]
    tw = table[targets.long()].float()
    pos = torch.arange(targets.shape[1], device=targets.device) // window
    tw = tw + torch.where((pos < T)[None, :, None],
                          fused[:, pos.clamp(max=T - 1)], fused.new_zeros(()))
    x = torch.cat([table[topic_ids.long()].float(), tw], 1)
    h = torch.tanh(product(x, p["projector1"]["w"], p["projector1"]["b"], prec))
    return product(h, p["projector2"]["w"], p["projector2"]["b"], prec)


class Dropout:
    """The masks of one training forward, worked out from its seeds: the
    embedding's and each layer's two residual masks are bits of
    ``torch.randint(0, 65536, shape)`` from a generator seeded with the
    mask's seed, kept at or above ``round(rate * 65536)``; an attention
    probability ``(b, h, i, j)`` is kept where a murmur3 hash of its
    coordinates in the padded ``[B, H, Tp, Tp]`` grid reaches ``round(rate *
    2^32)``. ``seeds``: ``1 + 3L`` draws of ``randint(0, 2^31 - 1)``: the
    embedding's, then per layer the attention's and the two residual ones."""

    def __init__(self, seeds, rate: float, B: int, T: int, Tp: int, D: int,
                 device):
        self.rate, self.Tp = rate, Tp
        thr = int(round(rate * 65536.0))
        self.keep_p = (65536 - thr) / 65536.0

        def bits(seed, shape):
            g = torch.Generator(device=device).manual_seed(int(seed))
            return torch.randint(0, 65536, shape, generator=g, device=device,
                                 dtype=torch.int32) >= thr

        L = (len(seeds) - 1) // 3
        self.embd = bits(seeds[0], (B, T, D))
        self.attn = [seeds[1 + 3 * l] for l in range(L)]
        self.resid = [(bits(seeds[2 + 3 * l], (B, Tp, D))[:, :T],
                       bits(seeds[3 + 3 * l], (B, Tp, D))[:, :T])
                      for l in range(L)]
        self.inv_keep = float(torch.tensor(1.0 / (1.0 - rate),
                                           dtype=torch.float32))

    def apply(self, x, mask, rows):
        return torch.where(mask[rows.start:rows.stop], x / self.keep_p,
                           x.new_zeros(()))

    def attention_keep(self, layer: int, rows: range, H: int, T: int, device):
        m32 = 0xFFFFFFFF

        def fmix(h):
            h = h ^ (h >> 16)
            h = (h * 0x85EBCA6B) & m32
            h = h ^ (h >> 13)
            h = (h * 0xC2B2AE35) & m32
            return h ^ (h >> 16)

        s = (self.attn[layer] + 0x9E3779B9) & m32
        b = torch.arange(rows.start, rows.stop, device=device, dtype=torch.int64)
        hh = torch.arange(H, device=device, dtype=torch.int64)
        i = torch.arange(T, device=device, dtype=torch.int64)
        row = ((b[:, None, None] * H + hh[None, :, None]) * self.Tp
               + i[None, None, :])
        rkey = fmix(row ^ fmix(torch.tensor(s, dtype=torch.int64)))
        cols = (i * 0x9E3779B9) & m32
        bits = fmix((rkey[..., None] + cols) & m32)
        thr = min(int(round(self.rate * 2.0 ** 32)), 2 ** 32 - 1)
        return bits >= thr


def gpt2(p, cfg: dict, embeds, types, mask, prec="f32",
         dropout: Optional[Dropout] = None, rows: Optional[range] = None):
    """GPT-2 over whole sequences ``[b, T, D]`` (learned positions, type ids
    embedded with the word table, causal attention with a key mask) →
    logits ``[b, T, V]`` of the tied LM head. ``dropout`` / ``rows``: the
    training masks, for the batch rows this block holds."""
    g = p["gpt2"]
    b, T, D = embeds.shape
    H = cfg["n_head"]
    hd = D // H
    eps = cfg["layer_norm_epsilon"]
    h = embeds + g["wpe"][:T][None] + g["wte"][types.long()]
    if dropout is not None:
        h = dropout.apply(h, dropout.embd, rows)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    allowed = causal[None, None] & (mask != 0)[:, None, None, :]
    for l in range(cfg["n_layer"]):
        lp = {k: v[l] for k, v in g["h"].items()}
        a = layer_norm(h, lp["ln1_g"], lp["ln1_b"], eps)
        q, k, v = (product(a, lp["attn_w"], lp["attn_b"], prec)
                   .view(b, T, 3, H, hd).permute(2, 0, 3, 1, 4))
        s = product(q, k.transpose(-1, -2), None, prec) / math.sqrt(hd)
        probs = torch.softmax(s.masked_fill(~allowed, NEG_INF), -1)
        if dropout is not None:
            keep = dropout.attention_keep(l, rows, H, T, h.device)
            probs = torch.where(keep, probs * dropout.inv_keep,
                                probs.new_zeros(()))
        ctx = product(probs, v, None, prec).transpose(1, 2).reshape(b, T, D)
        y = product(ctx, lp["attn_proj_w"], lp["attn_proj_b"], prec)
        if dropout is not None:
            y = dropout.apply(y, dropout.resid[l][0], rows)
        h = h + y
        m = layer_norm(h, lp["ln2_g"], lp["ln2_b"], eps)
        m = gelu_new(product(m, lp["mlp_fc_w"], lp["mlp_fc_b"], prec))
        y = product(m, lp["mlp_proj_w"], lp["mlp_proj_b"], prec)
        if dropout is not None:
            y = dropout.apply(y, dropout.resid[l][1], rows)
        h = h + y
    h = layer_norm(h, g["lnf_g"], g["lnf_b"], eps)
    return product(h, g["wte"].T, None, prec)


def forward(p, model: dict, data: dict, table, batch: Dict, targets,
            target_mask, prec="f32", dropout: Optional[Dropout] = None,
            rows: Optional[range] = None):
    """The whole model over [topic prompt | targets] → (logits ``[b, 15 +
    K, V]``, KL ``[b]``). ``targets`` ``[b, K]`` (position 0 = [#START#]),
    their type ids from :func:`type_ids` unless ``batch`` has
    ``type_ids``."""
    fused, kl = encode(p, model, batch["topic_emb"].float(),
                       batch["img_embs"].float(), batch["r_embs"].float(), prec)
    emb = decoder_inputs(p, table, fused, batch["topic_ids"], targets,
                         2 * (data["max_sent_length"] + 2), prec)
    tt = batch["type_ids"] if "type_ids" in batch else type_ids(
        targets, data["max_sent_length"] + 2, 10, data["max_sent_length"])
    types = torch.cat([batch["tpw_type_ids"].long(), tt.long()], 1)
    mask = torch.cat([batch["tpw_attention_mask"].long(), target_mask.long()], 1)
    return gpt2(p, model["gpt2"], emb, types, mask, prec, dropout, rows), kl


def as_float32(tree):
    if isinstance(tree, dict):
        return {k: as_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_float32(v) for v in tree]
    return tree.float()
