"""Device traces: ``torch.profiler`` over a stretch of the timed path, and
the reduction of its events to busy time, kernel self times by name and by
category, and idle gaps by what the host was doing.

The categories and the self-time sweep are a copy of the port's
``tools/trace_train.py`` (``CATEGORIES``, ``category``, ``parse_trace``),
except for the wall: an idle share is taken against the host clock's wall
of the traced stretch (``window_s``), not the span from the first device
event to the last. Only the GPU timeline and the CUDA runtime calls are
recorded on a card: recording every host operator slows a host-paced loop
and would stretch the very wall the idle share is read against.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATS = ("cpu_op",)
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")

CATEGORIES = [
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
IDLE_NO_CALL = "host between CUDA calls"


def category(name: str) -> str:
    """The first of :data:`CATEGORIES` whose pattern finds ``name`` (lower
    case), else ``"other"``."""
    hay = name.lower()
    for label, pat in _COMPILED:
        if pat.search(hay):
            return label
    return "other"


def parse(events: List[dict], window_s: float) -> Dict:
    """Reduce Chrome-trace events of a traced stretch whose host wall was
    ``window_s``: per device op its self time and count (a stack sweep per
    stream, so nested events are not counted twice), per category the sum,
    the busy time (the union of device intervals), and the gaps between
    device work, each named by the CUDA runtime call that overlaps it most
    (or :data:`IDLE_NO_CALL`). Without device events (a CPU run) the host
    operators stand in."""
    spans = [e for e in events if e.get("ph") == "X"]
    on_gpu = any(e.get("cat", "").lower() in DEVICE_CATS for e in spans)
    kept = DEVICE_CATS if on_gpu else CPU_CATS
    dev = [e for e in spans if e.get("cat", "").lower() in kept]
    by_stream = collections.defaultdict(list)
    for e in dev:
        by_stream[(e["pid"], e.get("tid"))].append(e)
    self_us = collections.Counter()
    count = collections.Counter()
    kernels = 0
    intervals = []
    for evs in by_stream.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack = []
        for e in evs:
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            while stack and stack[-1][0] <= ts + 1e-9:
                stack.pop()
            name = e.get("name", "?")
            self_us[name] += dur
            count[name] += 1
            kernels += e.get("cat", "").lower() in ("kernel", "cpu_op")
            if stack:
                self_us[stack[-1][1]] -= dur
            stack.append((ts + dur, name))
            intervals.append((ts, ts + dur))
    intervals.sort()
    merged = []
    for s, t in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    runtime = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                       e.get("name", "?")) for e in spans
                      if e.get("cat", "").lower() in RUNTIME_CATS))
    idle = collections.Counter()
    j = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while j < len(runtime) and runtime[j][1] <= a:
            j += 1
        best, best_ov = IDLE_NO_CALL, 0.0
        k = j
        while k < len(runtime) and runtime[k][0] < b:
            ov = min(b, runtime[k][1]) - max(a, runtime[k][0])
            if ov > best_ov:
                best, best_ov = runtime[k][2], ov
            k += 1
        idle[best] += b - a
    cats = collections.Counter()
    for name, us in self_us.items():
        cats[category(name)] += us
    return {"on_gpu": on_gpu, "window_s": window_s, "busy_s": busy_us / 1e6,
            "self_s": {k: v / 1e6 for k, v in self_us.items()},
            "count": dict(count), "kernels": kernels,
            "categories_s": {k: v / 1e6 for k, v in cats.items()},
            "idle_gaps_s": {k: v / 1e6 for k, v in idle.items()}}


def breakdown(parsed: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device ops with the most
    self time and the ten host activities with the most idle device time,
    ``[name, seconds]`` each."""
    top = sorted(parsed["self_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(parsed["idle_gaps_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}


def traced(fn: Callable[[], None], device: torch.device) -> Dict:
    """Run ``fn`` (work that ends with the device idle) under the
    profiler, between two synchronizations, and :func:`parse` its trace
    against the host wall of ``fn``. The trace file lives in a temporary
    directory under ``TMPDIR`` and is gone when this returns."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, wall)
