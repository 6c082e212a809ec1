"""Trace the train step of the port (``tools/trace_train.py`` of the JAX
package) and attribute every microsecond of device time.

The step is the full-width ``train.make_train_step`` at B=256 (bf16 compute,
f32 masters, dropout on, remat under the policy ``auto`` resolves to) on the
JAX tool's synthetic batch: one warm step, two more, then ``--steps`` K
chained steps inside ``utils/logging.maybe_profile`` (a ``torch.profiler``
Chrome trace, ``<out>/trace_<pid>_<ns>.json``; on a card the GPU timeline
alone, ``host_ops=False``, so that recording the host's operators does not
stretch the wall), ending in a synchronize.

:func:`parse_trace` reads the newest ``trace_*.json`` (or ``.json.gz``) under
a directory: the tool's own, a ``trace_decode`` run's, or the train CLI's
``--profile_dir``. Its device events are the GPU timeline (Kineto's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events) when the trace has one,
else the CPU operators of the traced threads (a ``--device cpu`` run). A
stack sweep per ``(pid, tid)`` gives every event its SELF time (nested spans
are not counted twice), so the per-op table, and the category table built
from it, sum to the busy total by construction; the wall is the last end
less the first start. It prints (a) the categories with their ms a step,
(b) the top ops, and writes the same as JSON with ``--json`` (the JAX tool's
keys: ``ms_per_step_busy``, ``ms_per_step_wall``, ``steps``,
``categories_ms``, ``top_ops_ms``).

Runs on the CUDA card (``--device cpu`` to run without one).

    python -m mmtg_tpu_torch.tools.trace_train [--batch 256] [--steps 3] [--json OUT]
    python -m mmtg_tpu_torch.tools.trace_train --parse-only --out DIR [--steps K]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

# Kineto's event categories on the GPU timeline (one stream a tid)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# what a --device cpu trace counts: the operators the traced threads ran
CPU_CATS = ("cpu_op",)

CATEGORIES = [
    # (label, regex over "name||long_name", lower case) — FIRST match wins,
    # order matters. The JAX tool's labels and order; its Pallas row names
    # the port's CUDA kernels (mmtg_tpu_torch/csrc/), in three rows; the
    # batch-invariant product and prefix sum fall in the rows of the library
    # calls they replace (dense matmul, reduce).
    ("attn kernel (CUDA mha_* fwd/bwd, decode_attention)",
     r"mha_\w*kernel|decode_attention\w*kernel"),
    ("decode step kernel (CUDA decode_block_fused)", r"decode_block_fused"),
    ("gru kernel (CUDA fused_gru)", r"fused_gru"),
    ("dense matmul (qkv/mlp/proj/lmhead)",
     r"nvjet|xmma|cutlass|gemm|gemv|cublas|splitkreduce|matmul_(?:bf16|f32|small)_kernel|"
     r"aten::(?:mm|addmm|bmm|baddbmm|matmul|linear|einsum|dot|mv|addmv)\b"),
    ("rng bits (dropout)",
     r"philox|distribution|curand|dropout|bernoulli|"
     r"aten::(?:rand|randn|randint|random_|normal_|uniform_)\b"),
    ("layernorm",
     r"layer_?norm|rowwisemoments|gammabeta|computeinternalgradients|"
     r"computegradientfusedparams"),
    ("gather/scatter (embed/wenlan)", r"gather|scatter|index|embedding"),
    ("reduce (grads/loss/stats)",
     r"reduce|softmax|row_cumsum|aten::(?:sum|mean|amax|amin|max|min|norm|var|std|"
     r"argmax|topk|sort|cumsum|logsumexp)\b"),
    ("copy/transpose/reshape",
     r"copy|transpose|reshape|permute|concat|catarray|slice|pad|memcpy|memset|"
     r"aten::(?:to|_to_copy|view|t|clone|contiguous|cat|stack|expand|select|"
     r"unsqueeze|squeeze|split|chunk|narrow|flatten|unflatten|as_strided|"
     r"empty\w*|zeros\w*|ones\w*|full\w*|fill_|zero_|resize_)\b"),
    ("elementwise fusion",
     r"elementwise|aten::(?:add|sub|mul|div|neg|exp|log|tanh|pow|rsqrt|sqrt|"
     r"where|gt|lt|ge|le|eq|ne|clamp\w*|maximum|minimum|abs|square|lerp|"
     r"addcmul|addcdiv|sigmoid|relu|gelu|bitwise_\w+|__\w+__)_?\b"),
]
_COMPILED = [(label, re.compile(pat)) for label, pat in CATEGORIES]


def category(name: str, long_name: str = "") -> str:
    """The category of an op: the first of :data:`CATEGORIES` whose regex
    finds ``name||long_name`` (lower case), else ``"other"``."""
    hay = (name + "||" + long_name).lower()
    for label, pat in _COMPILED:
        if pat.search(hay):
            return label
    return "other"


# -- the step -----------------------------------------------------------------


def synthetic_batch(B: int, mcfg, dcfg, rng: np.random.Generator):
    """The JAX tool's synthetic batch of ``B`` rows and its WenLan table, as
    numpy arrays, drawn from ``rng`` in the JAX tool's order (so equal to its
    arrays) → ``(batch, const)``."""
    P, T, E = dcfg.topic_prompt_length, dcfg.target_length, dcfg.wenlan_emb_size
    V = mcfg.gpt2.vocab_size
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    batch = {
        "topic_ids": i32(rng.integers(103, 8000, (B, P))),
        "tpw_attention_mask": np.ones((B, P), np.int32),
        "tpw_type_ids": np.ones((B, P), np.int32),
        "topic_emb": f32(rng.standard_normal((B, E))),
        "img_embs": f32(rng.standard_normal((B, 5, E))),
        "r_embs": f32(rng.standard_normal((B, 5, E))),
        "targets": i32(rng.integers(103, V, (B, T))),
        "attention_mask": np.ones((B, T), np.int32),
        "type_ids": i32(rng.integers(0, 5, (B, T))),
        "rating": f32(rng.integers(1, 6, (B,))),
        "sample_mask": np.ones((B,), np.float32),
    }
    const = {"wenlan_table": f32(rng.standard_normal((V, E)))}
    return batch, const


def build_step(batch_size, dtype, loss_impl, device, mcfg=None, dcfg=None):
    """``(step_fn, state, const, batch, stage)``: the train step at
    ``mcfg`` / ``dcfg`` (default: the full-size model) on ``device``, the
    port's seeded parameters (seed 0), a train state seeded 2 with 10 warm-up
    steps of 1000, the synthetic batch on the device, stage 3."""
    import torch

    from mmtg_tpu_torch.configs import DataConfig, ModelConfig, TrainConfig
    from mmtg_tpu_torch.params import init_params
    from mmtg_tpu_torch.train import create_train_state, make_train_step

    if (mcfg is None) != (dcfg is None):
        raise ValueError("pass mcfg and dcfg together")
    if mcfg is None:
        mcfg, dcfg = ModelConfig(), DataConfig()
    tcfg = TrainConfig(alpha=0.2, dtype=dtype, loss_impl=loss_impl)
    batch, const = synthetic_batch(batch_size, mcfg, dcfg, np.random.default_rng(0))
    to = lambda t: {k: torch.from_numpy(v).to(device) for k, v in t.items()}  # noqa: E731
    state, tx = create_train_state(2, mcfg, tcfg, 10, 1000,
                                   params=init_params(mcfg, seed=0), device=device)
    step_fn = make_train_step(mcfg, dcfg, tcfg, tx)
    return step_fn, state, to(const), to(batch), 3


# -- trace parsing --------------------------------------------------------------


def newest_trace(trace_dir: str) -> str:
    """The newest ``trace_*.json`` / ``trace_*.json.gz`` under ``trace_dir``
    (at any depth)."""
    paths = [p for pat in ("trace_*.json", "trace_*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise SystemExit(f"no trace_*.json under {trace_dir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def parse_trace(trace_dir, n_steps):
    """Self times of the device events of the newest trace under
    ``trace_dir``, per op and per category (see the module docstring);
    ``n_steps`` is the number of steps the trace holds (the tables are
    totals)."""
    events = _load(newest_trace(trace_dir))["traceEvents"]

    # pid -> process name (Kineto labels a GPU's process "GPU <n>"); tid ->
    # thread name
    pname, tname = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args") or {}
        if e.get("name") == "process_name":
            pname.setdefault(e["pid"], args.get("name", ""))
        elif e.get("name") == "process_labels" and args.get("labels"):
            pname[e["pid"]] = args["labels"]
        elif e.get("name") == "thread_name":
            tname[(e["pid"], e.get("tid"))] = args.get("name", "")

    spans_x = [e for e in events if e.get("ph") == "X"]
    on_gpu = any(e.get("cat", "").lower() in DEVICE_CATS for e in spans_x)
    cats_kept = DEVICE_CATS if on_gpu else CPU_CATS
    device_events = [e for e in spans_x if e.get("cat", "").lower() in cats_kept]
    device_pids = {e["pid"] for e in device_events}

    # SELF time per event, per (pid, tid): a stack sweep over start-sorted
    # events subtracts each child's wall from its innermost enclosing
    # parent (on one CUDA stream nothing nests; CPU operators do), so the
    # per-op table sums to the busy total by construction.
    by_thread = collections.defaultdict(list)
    for e in device_events:
        by_thread[(e["pid"], e.get("tid"))].append(e)

    per_op = collections.Counter()          # name -> total SELF us
    per_op_count = collections.Counter()
    long_names = {}
    spans = []                              # (ts, end) of every device event
    for key, evs in by_thread.items():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack = []  # (end_ts, name) of open parents
        for e in evs:
            ts = float(e["ts"])
            dur = float(e.get("dur", 0.0))
            end = ts + dur
            while stack and stack[-1][0] <= ts + 1e-9:
                stack.pop()
            name = e.get("name", "?")
            per_op[name] += dur
            per_op_count[name] += 1
            if stack:
                per_op[stack[-1][1]] -= dur  # child time is not parent SELF time
            args = e.get("args") or {}
            ln = args.get("long_name") or args.get("hlo_op") or ""
            if ln and name not in long_names:
                long_names[name] = ln[:220]
            spans.append((ts, end))
            stack.append((end, name))

    total_us = sum(per_op.values())
    # wall of the traced region on the device = max end - min start
    wall_us = (max(s[1] for s in spans) - min(s[0] for s in spans)) if spans else 0.0

    cats = collections.Counter()
    cat_ops = collections.defaultdict(collections.Counter)
    for name, us in per_op.items():
        label = category(name, long_names.get(name, ""))
        cats[label] += us
        cat_ops[label][name] += us
    return {
        "total_us": total_us,
        "wall_us": wall_us,
        "per_op": per_op,
        "per_op_count": per_op_count,
        "long_names": long_names,
        "cats": cats,
        "cat_ops": cat_ops,
        "thread_names": tname,
        "device_pids": device_pids,
        "pname": pname,
        "on_gpu": on_gpu,
    }


def summary(r: dict, k: int, top: int) -> dict:
    """The ``--json`` object of a parse of ``k`` steps (the JAX tool's keys)."""
    return {
        "ms_per_step_busy": r["total_us"] / 1e3 / k,
        "ms_per_step_wall": r["wall_us"] / 1e3 / k,
        "steps": k,
        "categories_ms": {label: us / 1e3 / k for label, us in r["cats"].most_common()},
        "top_ops_ms": {name: round(us / 1e3 / k, 2)
                       for name, us in r["per_op"].most_common(top)},
    }


def print_report(r: dict, k: int, top: int) -> None:
    print(f"\ndevice pids: { {p: r['pname'].get(p, '') for p in sorted(r['device_pids'])} }"
          f" ({'GPU timeline' if r['on_gpu'] else 'CPU operators'})")
    print(f"device busy total: {r['total_us']/1e3/k:.1f} ms/step   "
          f"device wall: {r['wall_us']/1e3/k:.1f} ms/step   (over {k} steps)")

    print("\n== categories (sum == busy total by construction) ==")
    for label, us in r["cats"].most_common():
        print(f"  {us/1e3/k:8.1f} ms  {label}")
    print(f"  {r['total_us']/1e3/k:8.1f} ms  TOTAL")

    print(f"\n== top {top} ops ==")
    for name, us in r["per_op"].most_common(top):
        n = r["per_op_count"][name]
        ln = r["long_names"].get(name, "")
        print(f"  {us/1e3/k:8.2f} ms  x{n:5d}  {name[:110]}   {ln[:90]}")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--loss-impl", default="auto")
    ap.add_argument("--steps", type=int, default=3,
                    help="chained steps inside the traced region")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "trace_train"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--json", default="",
                    help="also write the category table as JSON")
    ap.add_argument("--parse-only", action="store_true",
                    help="re-parse an existing --out dir, no run on the device")
    ap.add_argument("--device", default=None, type=str,
                    help="torch device (default: cuda; pass 'cpu' to run "
                         "without a GPU)")
    return ap


def run(args, mcfg=None, dcfg=None) -> dict:
    """Trace (unless ``--parse-only``), parse, print → ``{"parse": the
    parse_trace dict, "summary": the --json object, "wall_ms_per_step": the
    host's wall a traced step, or None}``. ``mcfg`` / ``dcfg`` drive it at
    another model configuration."""
    wall = None
    if not args.parse_only:
        from mmtg_tpu_torch.generate import resolve_device
        from mmtg_tpu_torch.tools.serve_common import sync
        from mmtg_tpu_torch.utils.logging import maybe_profile

        device = resolve_device(args.device)
        step_fn, state, const, batch, stage = build_step(
            args.batch, args.dtype, args.loss_impl, device, mcfg, dcfg)

        state, m = step_fn(state, const, batch, stage)   # first step
        float(m["total"])
        for _ in range(2):                               # warm
            state, m = step_fn(state, const, batch, stage)
        float(m["total"])

        t0 = time.perf_counter()
        with maybe_profile(args.out, host_ops=device.type == "cpu"):
            for _ in range(args.steps):
                state, m = step_fn(state, const, batch, stage)
            float(m["total"])
            sync(device)
        wall = (time.perf_counter() - t0) / args.steps
        print(f"traced {args.steps} steps, {wall*1e3:.1f} ms/step wall "
              f"(incl. the profiler's start, one sync and the trace's export) -> {args.out}")

    r = parse_trace(args.out, args.steps)
    k = args.steps
    print_report(r, k, args.top)
    s = summary(r, k, args.top)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
        print(f"\nwrote {args.json}")
    return {"parse": r, "summary": s,
            "wall_ms_per_step": None if wall is None else wall * 1e3}


def main(argv=None) -> int:
    run(build_arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
