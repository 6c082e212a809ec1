"""Training on rated lyrics: the step of ``train.make_train_step``, bf16
compute on f32 master weights, dropout on, remat as ``auto`` resolves it,
cycling over a pool of seeded batches already on the card.

Set-up builds the train state once and drives it through its first
``check_steps`` steps (the check reads their losses, the first gradient
from the AdamW moment, and the weights' change after the last of them);
the same state then steps on in the window, dispatched ahead, with one
synchronize when the window is spent. ``train_samples_s`` is the rows
stepped over the window's wall. With a trace, five steps of the window
run under the profiler.
"""

from __future__ import annotations

import statistics
import time

import torch

from h100bench import harness, seeded, trace, work
from h100bench.reference import model as ref
from h100bench.reference import train as reftrain

TRACED_STEPS = 5


def _opt(tr: dict) -> dict:
    return {k: tr[k] for k in ("lr", "warmup_steps", "total_steps", "b1", "b2",
                               "eps", "weight_decay", "clip_norm", "alpha")}


def dropout_seed(seed: int) -> int:
    """The seed of the train state's dropout generator (the program seeds
    it with this plus one)."""
    return seeded.sub_seed(seed, "dropout") >> 2


def run(ctx: harness.Context) -> harness.Record:
    from mmtg_tpu_torch import train
    from mmtg_tpu_torch.configs import TrainConfig

    tr, dev = ctx.traffic, ctx.device
    m, d = ctx.config["model"], ctx.config["data"]
    mcfg, dcfg = harness.model_configs(ctx.config)
    B, stage, n_check = tr["batch"], tr["stage"], tr["check_steps"]
    o = _opt(tr)
    tcfg = TrainConfig(
        batch_size=B, lr=o["lr"], alpha=o["alpha"], dtype=tr["dtype"],
        grad_clip_norm=o["clip_norm"], adam_b1=o["b1"], adam_b2=o["b2"],
        adam_eps=o["eps"], weight_decay=o["weight_decay"], remat=True,
        remat_policy=tr["remat_policy"], loss_impl=tr["loss_impl"])
    const = {"wenlan_table": seeded.make_table(
        m["gpt2"]["vocab_size"], d["wenlan_emb_size"], ctx.seed, dev,
        torch.float32)}
    pool = [seeded.train_batch(B, d, m, ctx.seed, i, dev)
            for i in range(tr["pool"])]
    state, tx = train.create_train_state(
        dropout_seed(ctx.seed), mcfg, tcfg, o["warmup_steps"], o["total_steps"],
        params=seeded.make_weights(m, ctx.seed, dev, torch.float32), device=dev)
    step_fn = ctx.faults.get("step", lambda f: f)(
        train.make_train_step(mcfg, dcfg, tcfg, tx))
    path = {"dtype": tr["dtype"], "batch": B, "stage": stage,
            "remat_policy": train._resolve_remat_policy(
                tcfg.remat_policy, pool[0], None, d["topic_prompt_length"]),
            "loss_impl": train._resolve_loss_impl(
                tcfg.loss_impl, pool[0], m["gpt2"]["vocab_size"])}

    losses, first_grad = [], {}
    for i in range(n_check):
        state, met = step_fn(state, const, pool[i], stage)
        losses.append(float(met["total"]))
        if i == 0:
            first_grad = {k: float(v.norm() / (1.0 - o["b1"]))
                          for k, v in reftrain.leaves(state.opt_state["mu"]).items()}
    p0 = reftrain.leaves(seeded.make_weights(m, ctx.seed, dev, torch.float32))
    change = {k: float((v.detach() - p0[k]).norm())
              for k, v in reftrain.leaves(state.params).items()}
    del p0
    setup_s = time.perf_counter() - ctx.t0

    traced, steps = None, 0
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        if ctx.trace and steps == 1:
            def some():
                nonlocal state
                for j in range(TRACED_STEPS):
                    state, _ = step_fn(state, const,
                                       pool[(n_check + steps + j) % len(pool)],
                                       stage)
            traced = trace.traced(some, dev)
            steps += TRACED_STEPS
            continue
        state, _ = step_fn(state, const, pool[(n_check + steps) % len(pool)], stage)
        steps += 1
    harness.sync(dev)
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, tx, step_fn, const
    pool = pool[:n_check]
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings, worst = check(ctx, pool, losses, first_grad, change, m, d)
    checks, correct = harness.judge(readings, ctx.limits)
    rec = harness.Record(
        setup_s=setup_s, end_to_end={"train_samples_s": B * steps / wall},
        attempted=steps, failed=0, memory_peak_bytes=peak, checks=checks,
        correct=correct, path=dict(path, worst=worst), trace=traced,
        readings=readings,
        check_s=time.perf_counter() - t_check)
    if traced is not None and dev.type == "cuda":
        pk = work.peaks(torch.cuda.get_device_name(dev))
        rec.work = {"steps": TRACED_STEPS,
                    "flops": work.train_flops_model(m, d, B),
                    "bf16_peak": pk["bfloat16"],
                    "attn_least_s": work.train_attention_least(m, d, B, pk)}
    return rec


def reference_readings(ctx, pool, m, d, prec: str) -> tuple:
    """The reference's losses, first clipped gradients and weight changes
    over the first steps, in float32 (or float8 products)."""
    tr, dev = ctx.traffic, ctx.device
    ref.set_exact_float32()
    steps = reftrain.Steps(
        seeded.make_weights(m, ctx.seed, dev, torch.float32), m, d,
        seeded.make_table(m["gpt2"]["vocab_size"], d["wenlan_emb_size"],
                          ctx.seed, dev, torch.float32),
        _opt(tr), prec, tr["check_block"])
    draws = torch.Generator().manual_seed(dropout_seed(ctx.seed) + 1)
    L = m["gpt2"]["n_layer"]
    losses = []
    for i in range(tr["check_steps"]):
        seeds = torch.randint(0, 2 ** 31 - 1, (1 + 3 * L,), generator=draws).tolist()
        losses.append(steps.step(pool[i], tr["stage"], seeds))
    p0 = reftrain.leaves(seeded.make_weights(m, ctx.seed, dev, torch.float32))
    grad = {k: float(v.norm()) for k, v in steps.first_grads.items()}
    change = {k: float((v.detach() - p0[k]).norm()) for k, v in steps.p.items()}
    return losses, grad, change


def compare(losses, grad, change, r_losses, r_grad, r_change) -> tuple:
    """``loss``: the largest relative gap of a step's objective. ``grad`` /
    ``change``: by the worst leaf, the gap between the two norms of the
    first clipped gradient / of the weights' change over the steps, over
    the reference leaf's norm or the median leaf's, whichever is larger;
    ``grad_median`` / ``change_median``: the median leaf's gap. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (they move by round-off alone). Returns (readings, the
    worst leaf of each)."""
    med_g = statistics.median(r_grad.values())
    live = [k for k in r_grad if r_grad[k] >= 1e-3 * med_g]
    med_c = statistics.median(r_change[k] for k in live)

    def gaps(a, b, med):
        return {k: abs(a[k] - b[k]) / max(b[k], med) for k in live}

    g, c = gaps(grad, r_grad, med_g), gaps(change, r_change, med_c)
    readings = {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
        "grad": max(g.values()), "change": max(c.values()),
        "grad_median": statistics.median(g.values()),
        "change_median": statistics.median(c.values())}
    worst = {"grad": max(g, key=g.get), "change": max(c, key=c.get),
             "left_out": sorted(set(r_grad) - set(live))}
    return readings, worst


def check(ctx, pool, losses, grad, change, m, d) -> tuple:
    r = reference_readings(ctx, pool, m, d, "f32")
    return compare(losses, grad, change, *r)


def control_readings(ctx: harness.Context) -> dict:
    """The control: the reference with float8 products in the program's
    place, held against the float32 reference on the same batches."""
    m, d, tr = ctx.config["model"], ctx.config["data"], ctx.traffic
    pool = [seeded.train_batch(tr["batch"], d, m, ctx.seed, i, ctx.device)
            for i in range(tr["check_steps"])]
    low = reference_readings(ctx, pool, m, d, "fp8")
    readings, worst = compare(*low, *reference_readings(ctx, pool, m, d, "f32"))
    return dict(readings, worst=worst)
