"""Offline batch generation: whole ``decoding.generate`` calls of the
traffic's batch, back to back, each ending in a synchronize, until the
window is spent. Every call samples with the traffic's settings (the
``generate`` CLI's defaults), over the pool's prompt batches in turn.

``generate_tok_s`` is batch x length tokens a call over the summed wall of
the calls. With a trace, the window's second call runs under the
profiler.
"""

from __future__ import annotations

import math
import time

import torch

from h100bench import harness, seeded, trace, work
from h100bench.reference import model as ref

FRAME_EOS, FRAME_START = 2, 1
BANNED = (1, 2, 100, 102)      # [#START#], [#EOS#], [UNK], [SEP]
PENALTY_EXEMPT = (0, 102)      # [PAD], [SEP]
STEP = 2.0 ** -6  # a bf16 step between 2 and 4
TOP = 32  # candidates looked at beyond the top-k (a token further down fails it)


def _gcfg(tr: dict):
    from mmtg_tpu_torch.configs import GenerateConfig

    return GenerateConfig(
        batch_size=tr["batch"], temperature=tr["temperature"],
        top_k=tr["top_k"], top_p=tr["top_p"],
        repetition_penalty=tr["repetition_penalty"], length=tr["length"],
        cache_dtype=tr["cache_dtype"], weight_dtype=tr["weight_dtype"],
        attn_impl=tr["attn_impl"])


def run(ctx: harness.Context) -> harness.Record:
    from mmtg_tpu_torch import decoding

    tr, dev = ctx.traffic, ctx.device
    m, d = ctx.config["model"], ctx.config["data"]
    mcfg, dcfg = harness.model_configs(ctx.config)
    B, length = tr["batch"], tr["length"]
    dtype = getattr(torch, tr["dtype"])
    params = seeded.make_weights(m, ctx.seed, dev, dtype)
    const = {"wenlan_table": seeded.make_table(
        m["gpt2"]["vocab_size"], d["wenlan_emb_size"], ctx.seed, dev, dtype)}
    pool = [seeded.generate_batch(B, d, m, ctx.seed, i, dev, dtype)
            for i in range(tr["pool"])]
    gcfg = _gcfg(tr)
    d_kv = m["gpt2"]["n_embd"]
    path = {"attn_impl": decoding.resolve_attn_impl(gcfg, d_kv, None, B),
            "cache_dtype": decoding.resolve_cache_dtype(gcfg, B),
            "weight_dtype": decoding.resolve_weight_dtype(gcfg, B),
            "dtype": tr["dtype"], "batch": B, "length": length}
    generate = ctx.faults.get("generate", decoding.generate)

    def call(batch, gen):
        return generate(params, const, mcfg, dcfg, gcfg, batch, gen)

    call(pool[0], seeded.generator(ctx.seed, "warm", dev))
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    gen = seeded.generator(ctx.seed, "sampling", dev)
    walls, outs, traced = [], [], None
    start = time.perf_counter()
    c = 0
    while time.perf_counter() - start < ctx.seconds or not outs:
        bi = c % len(pool)
        if ctx.trace and c == 1:
            box = {}
            t = time.perf_counter()
            traced = trace.traced(
                lambda: box.setdefault("toks", call(pool[bi], gen)), dev)
            toks = box["toks"]
            walls.append(time.perf_counter() - t)
            traced_tokens = toks.cpu()
        else:
            t = time.perf_counter()
            toks = call(pool[bi], gen)
            harness.sync(dev)
            walls.append(time.perf_counter() - t)
        outs.append((bi, toks))
        c += 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, const
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings = check(ctx, pool, outs, m, d, dtype)
    checks, correct = harness.judge(readings, ctx.limits)
    rec = harness.Record(
        setup_s=setup_s,
        end_to_end={"generate_tok_s": B * length * len(walls) / sum(walls)},
        attempted=B * len(walls), failed=0, memory_peak_bytes=peak,
        checks=checks, correct=correct, path=path, trace=traced,
        readings=readings, walls=walls, check_s=time.perf_counter() - t_check)
    if traced is not None and dev.type == "cuda":
        _work(rec, m, d, B, length, traced_tokens, dev)
    return rec


def _work(rec, m, d, B, length, tokens, dev):
    """The traced call's modeled work (the card's peaks by its name)."""
    pk = work.peaks(torch.cuda.get_device_name(dev))
    slots = work.live_slots(tokens, d["topic_prompt_length"])
    rec.work = {
        "steps": length,
        "flops": work.generate_flops(m, d, B, length, slots),
        "bf16_peak": pk["bfloat16"],
        "decode_attn_least_s": work.decode_attention_least(m, d, B, slots, pk),
        "matmul_least_s": work.product_least(
            work.generate_products(m, d, B, length), pk),
    }


@torch.no_grad()
def check(ctx, pool, outs, m, d, dtype) -> dict:
    """Rows drawn from the seed among all the window's calls, against the
    plain reference over their prompts and served tokens. A token a row
    sampled freely has to lie in the set the traffic's sampling draws from
    (top-k, then top-p, on the logits after the repetition penalty, the
    bans and the temperature), as the reference's logits give it: its
    ``margin`` is the least shift of every logit towards the token that
    puts it in the set (see :func:`set_margin`). ``margin`` the widest,
    ``outside_share`` the share of tokens whose margin passes one bf16
    step at logits of 2-4 (``_2step`` two steps), and
    ``frame_mismatches`` the frame tokens and the [PAD] runs that differ
    from what the frame forces."""
    tr, dev = ctx.traffic, ctx.device
    ref.set_exact_float32()
    n = tr["check_rows"]
    B = tr["batch"]
    pick = torch.Generator().manual_seed(seeded.sub_seed(ctx.seed, "check"))
    picks = torch.randperm(len(outs) * B, generator=pick)[:n].tolist()
    weights = ref.as_float32(seeded.make_weights(m, ctx.seed, dev, dtype))
    table = seeded.make_table(m["gpt2"]["vocab_size"], d["wenlan_emb_size"],
                              ctx.seed, dev, dtype).float()
    P = d["topic_prompt_length"]
    frame = d["max_sent_length"] + 2
    found, mismatches, block = [], 0, tr["check_block"]
    for lo in range(0, len(picks), block):
        sel = picks[lo:lo + block]
        batch = {k: torch.stack([pool[outs[p // B][0]][k][p % B]
                                 for p in sel]) for k in pool[0]}
        toks = torch.stack([outs[p // B][1][p % B] for p in sel]).long()
        logits, _ = ref.forward(weights, m, d, table, batch, toks,
                                toks != ref.PAD)
        v, mm = margins(logits[:, P:P + toks.shape[1] - 1], toks, tr, frame)
        found.append(v)
        mismatches += mm
    v = torch.cat(found)
    return {"margin": float(v.max()),
            "outside_share": float((v > STEP).float().mean()),
            "outside_share_2step": float((v > 2 * STEP).float().mean()),
            "frame_mismatches": float(mismatches)}


def margins(logits, toks, tr: dict, frame: int):
    """``logits[:, i]`` predict ``toks[:, i + 1]``. Returns (the margin of
    each freely sampled token, the count of forced tokens that differ). A
    step is forced when it closes or opens a sentence of the frame
    (whatever came before), or when the previous token is [PAD] (then
    [PAD])."""
    b, n, V = logits.shape
    penalty = tr["repetition_penalty"]
    seen = torch.zeros(b, V, device=logits.device)
    seen.scatter_add_(1, toks[:, :1], torch.ones_like(toks[:, :1], dtype=seen.dtype))
    exempt = torch.tensor(PENALTY_EXEMPT, device=logits.device)
    found, mismatches = [], 0
    for i in range(n):
        served, prev = toks[:, i + 1], toks[:, i]
        r = (i + 2) % frame
        forced = None
        if i > 0 and r == 0:
            forced = FRAME_EOS
        elif i > 0 and r == 1:
            forced = FRAME_START
        pad = prev == ref.PAD
        if forced is not None:
            mismatches += int((served != forced).sum())
        else:
            mismatches += int(((served != ref.PAD) & pad).sum())
            counts = seen.clone()
            counts[:, exempt] = 0
            x = logits[:, i].float() * torch.pow(penalty, -counts)
            x[:, list(BANNED)] = ref.NEG_INF
            v = set_margin(x, served, tr["temperature"], tr["top_k"],
                           tr["top_p"])
            found.append(v[~pad])
        seen.scatter_add_(1, served[:, None], torch.ones_like(seen[:, :1]))
    return torch.cat(found).cpu(), mismatches


def set_margin(x, t, temperature: float, k: int, p: float):
    """The least ``delta`` such that token ``t[r]`` is in the sampling set
    of row ``r`` when every logit of ``x`` (after the penalty and the
    bans, before the temperature) may move by ``delta``: the token up, the
    others down. The set is the program's rule: the ``k`` largest, then
    the first of them, in order, whose probabilities (a softmax over the
    ``k`` at the temperature) ahead sum to at most ``p``.

    The top-k holds the token once the ``k``-th largest lies at most
    ``2 delta`` above it. For the nucleus, the tokens more than ``2 delta``
    above it are those surely ahead; their mass under the shift is at least
    ``e^(-2 delta / temperature)`` times their mass ``W`` in the
    reference's softmax, so ``delta >= temperature / 2 ln(W / p)`` puts the
    token in: the least ``delta`` is the least over the number of tokens
    taken as ahead."""
    xt = x.gather(1, t[:, None])                         # [b, 1]
    top = torch.topk(x, TOP, dim=-1).values              # [b, TOP], descending
    y = top / temperature
    w = torch.exp(y - y[:, :1])
    w = w / w[:, :k].sum(-1, keepdim=True)
    need_k = (top[:, k - 1:k] - xt).clamp_min(0.0) / 2
    mass = torch.cat([torch.zeros_like(w[:, :1]), w.cumsum(-1)], -1)  # W_0..W_TOP
    need_p = (temperature / 2 * torch.log(mass / p)).clamp_min(0.0)
    nxt = torch.cat([top, torch.full_like(top[:, :1], -math.inf)], -1)
    lo = ((nxt - xt) / 2).clamp_min(0.0)                 # tokens past r not ahead
    need_p = torch.maximum(lo, need_p).min(-1).values
    return torch.maximum(need_k[:, 0], need_p)
