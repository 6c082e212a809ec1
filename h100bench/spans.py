"""The program's spans on the device trace: every kernel, copy and fill of
a traced stretch put down to the program's own layer, and every idle gap
of the card to what the program was doing.

The port records spans (``mmtg_tpu_torch.utils.logging.span``:
``decode.call`` / ``decode.setup`` / ``decode.step`` / ``decode.sample`` /
``decode.embed`` / ``decode.model``, ``train.step`` / ``train.forward`` /
``train.backward`` / ``train.optimizer``, ``kernels.load`` /
``kernels.build``) on the clock of the profiler's Chrome trace, and writes
them into it as events of category :data:`SPAN_CAT`.
:func:`attribute` joins each device event to the runtime call that
launched it by the trace's ``correlation`` id, and gives it to the
innermost span open at that call's host time, whatever thread made it (the
autograd engine launches the backward from a thread of its own while the
caller waits inside ``train.backward``). Each gap between device work goes
to the innermost span open over at least half of it.

    python3 h100bench/spans.py --workload <name> --seed <n> --seconds <s>

runs one cell as ``run.py --trace 1`` does, with the span recorder on from
the start of set-up and the traced stretch reduced by :func:`traced` in
place of ``trace.traced``; before the result line it prints ``# spans``
(the reduction) and ``# span_metrics`` (:func:`readings`). It exits 1,
with no readings, when the traced stretch does not pass :func:`fault`.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100bench import trace as tr  # noqa: E402

SPAN_CAT = "program_span"  # the program's ``utils.logging.SPAN_CAT``
OUTSIDE = "outside any span"
SAMPLE, MODEL, SETUP, CALL = ("decode.sample", "decode.model", "decode.setup",
                              "decode.call")
STEP, FORWARD, BACKWARD, OPTIMIZER = ("train.step", "train.forward",
                                      "train.backward", "train.optimizer")


class _Innermost:
    """The innermost span open at a time: the timeline cut at every span's
    start and end, each piece held by the deepest span open over it (the
    latest started among equals; spans of several threads may overlap)."""

    def __init__(self, spans: List[dict]):
        self.by_id = {s["args"]["id"]: s for s in spans}
        depth = {}

        def d(i):
            if i not in depth:
                p = self.by_id[i]["args"]["parent"]
                depth[i] = 0 if p not in self.by_id else d(p) + 1
            return depth[i]

        edges = collections.defaultdict(lambda: ([], []))
        for s in spans:
            t0 = float(s["ts"])
            edges[t0][0].append(s)
            edges[t0 + float(s.get("dur", 0.0))][1].append(s)
        self.cuts, self.top = sorted(edges), []
        live = {}
        for t in self.cuts:
            opened, closed = edges[t]
            for s in closed:
                live.pop(s["args"]["id"], None)
            for s in opened:
                if float(s.get("dur", 0.0)) > 0:
                    live[s["args"]["id"]] = (d(s["args"]["id"]), float(s["ts"]))
            self.top.append(max(live, key=live.get) if live else None)

    def at(self, t: float) -> Optional[dict]:
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.by_id.get(self.top[i]) if i >= 0 else None

    def parent(self, s: dict) -> Optional[dict]:
        return self.by_id.get(s["args"]["parent"])


def attribute(events: List[dict]) -> Dict:
    """The reduction of a trace that holds the program's spans:

    - ``device_by_span_s``: device seconds by the innermost span open at
      each event's launch (its self time);
    - ``device_under_span_s``: the same with each span's descendants
      counted in it too; ``device_by_span_op_s`` by that span and the
      device op's name (``"<span> | <op>"``);
    - ``unattributed_s``: device seconds whose launch no span holds, or
      whose launch the trace lacks;
    - ``idle_by_span_s``: each gap between device work (as ``trace.parse``
      finds them) by the innermost span open over at least half of it, or
      :data:`OUTSIDE`; ``idle_by_span_call_s`` by that span and the runtime
      call that overlaps the gap most (``"<span> | <call>"``);
    - ``span_counts``: the spans of the trace by name."""
    xs = [e for e in events if e.get("ph") == "X"]
    spans = [e for e in xs if e.get("cat") == SPAN_CAT]
    inner = _Innermost(spans)
    calls = [e for e in xs if e.get("cat", "").lower() in tr.RUNTIME_CATS]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in calls
              if "correlation" in e.get("args", {})}
    dev = [e for e in xs if e.get("cat", "").lower() in tr.DEVICE_CATS]
    by, under, by_op = (collections.Counter(), collections.Counter(),
                        collections.Counter())
    unattributed = 0.0
    for e in dev:
        dur = float(e.get("dur", 0.0))
        t = launch.get(e.get("args", {}).get("correlation"))
        s = inner.at(t) if t is not None else None
        if s is None:
            unattributed += dur
            continue
        by[s["name"]] += dur
        by_op[f"{s['name']} | {e.get('name', '?')}"] += dur
        names = set()
        while s is not None:
            names.add(s["name"])
            s = inner.parent(s)
        for n in names:
            under[n] += dur
    merged = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                       for e in dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    runtime = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                      e.get("name", "?")) for e in calls)
    idle, idle_call = collections.Counter(), collections.Counter()
    j = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        s = inner.at((a + b) / 2)
        while s is not None and (min(b, float(s["ts"]) + float(s["dur"]))
                                 - max(a, float(s["ts"]))) * 2 < b - a:
            s = inner.parent(s)
        name = s["name"] if s is not None else OUTSIDE
        while j < len(runtime) and runtime[j][1] <= a:
            j += 1
        call, best, k = tr.IDLE_NO_CALL, 0.0, j
        while k < len(runtime) and runtime[k][0] < b:
            ov = min(b, runtime[k][1]) - max(a, runtime[k][0])
            if ov > best:
                call, best = runtime[k][2], ov
            k += 1
        idle[name] += b - a
        idle_call[f"{name} | {call}"] += b - a
    return {"device_by_span_s": {k: v / 1e6 for k, v in by.items()},
            "device_under_span_s": {k: v / 1e6 for k, v in under.items()},
            "device_by_span_op_s": {k: v / 1e6 for k, v in by_op.items()},
            "unattributed_s": unattributed / 1e6,
            "idle_by_span_s": {k: v / 1e6 for k, v in idle.items()},
            "idle_by_span_call_s": {k: v / 1e6 for k, v in idle_call.items()},
            "span_counts": dict(collections.Counter(s["name"] for s in spans))}


def traced(fn: Callable[[], None], device) -> Dict:
    """``trace.traced``, with the program's spans of the stretch recorded,
    written into the trace's events, and reduced by :func:`attribute`
    beside ``trace.parse``'s keys; also ``stretch_span_ids``, the ids of
    the stretch's spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmtg_tpu_torch.utils.logging import chrome_span_events, record_spans

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof, record_spans() as spans:
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
            trace = json.load(f)
    events = trace["traceEvents"] + chrome_span_events(
        spans, int(trace.get("baseTimeNanoseconds", 0)))
    out = tr.parse(events, wall)
    out.update(attribute(events), stretch_span_ids=[s.id for s in spans])
    return out


def readings(t: Dict, spans: List = ()) -> Dict[str, float]:
    """The span-based per-layer readings of a traced stretch ``t``
    (:func:`traced`), each left out where its spans are missing:
    ``generate.sample_ms_per_step`` / ``generate.model_ms_per_step``
    (device ms under ``decode.sample`` / ``decode.model`` over their
    spans), ``generate.setup_ms`` (device ms under ``decode.setup`` a
    call), ``train.forward_ms`` / ``train.backward_ms`` /
    ``train.optimizer_ms`` (device ms under each over the ``train.step``
    spans), and from ``spans``, the run's every span,
    ``generate.warm_call_extra_s``: the first ``decode.call``'s host wall
    less the median of those the stretch does not hold, bar the first."""
    under, n = t.get("device_under_span_s", {}), t.get("span_counts", {})
    out = {}

    def per(name, count_of, metric):
        if n.get(count_of) and name in under:
            out[metric] = 1e3 * under[name] / n[count_of]

    per(SAMPLE, SAMPLE, "generate.sample_ms_per_step")
    per(MODEL, MODEL, "generate.model_ms_per_step")
    per(SETUP, SETUP, "generate.setup_ms")
    per(FORWARD, STEP, "train.forward_ms")
    per(BACKWARD, STEP, "train.backward_ms")
    per(OPTIMIZER, STEP, "train.optimizer_ms")
    inside = set(t.get("stretch_span_ids", ()))
    calls = sorted((s for s in spans if s.name == CALL), key=lambda s: s.start_ns)
    later = [s.end_ns - s.start_ns for s in calls[1:] if s.id not in inside]
    if later:
        out["generate.warm_call_extra_s"] = (
            calls[0].end_ns - calls[0].start_ns - statistics.median(later)) / 1e9
    return out


def fault(t: Dict, most_unattributed: float = 0.01) -> Optional[str]:
    """Why the traced stretch ``t`` (:func:`traced`) cannot be read, or
    None: it holds no span (the recorder was off, or the cell's driver
    traced by another route than ``trace.traced``), or more than
    ``most_unattributed`` of its busy time was launched outside any span."""
    if not t.get("span_counts"):
        return "the traced stretch holds no span"
    busy, un = t.get("busy_s") or 0.0, t.get("unattributed_s", 0.0)
    if un > most_unattributed * busy:
        return (f"unattributed {un:.6f} s is over {most_unattributed:.0%} "
                f"of busy {busy:.6f} s")
    return None


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from unittest import mock

    import torch

    from h100bench import harness
    from mmtg_tpu_torch.utils.logging import record_spans

    if not torch.cuda.is_available():
        print("h100bench: no CUDA device: nothing is measured", file=sys.stderr)
        return 1
    man = harness.manifest()
    device = torch.device("cuda", 0)
    with mock.patch.object(tr, "traced", traced), record_spans() as every:
        rec = harness.run_cell(args.workload, args.seed, args.seconds, True,
                               device, t0, man)
    out = harness.result(man, args.workload, rec, True,
                         torch.cuda.get_device_name(device),
                         harness.workload(man, args.workload)["chips"])
    t = rec.trace or {}
    why = fault(t)
    if why is not None:
        print(f"h100bench: spans: {why}: nothing is read", file=sys.stderr)
        return 1
    keys = ("window_s", "busy_s", "device_by_span_s", "device_under_span_s",
            "unattributed_s", "idle_by_span_s", "idle_by_span_call_s",
            "span_counts", "idle_gaps_s")
    line = {k: t.get(k) for k in keys}
    line["device_by_span_op_s"] = dict(sorted(
        t.get("device_by_span_op_s", {}).items(), key=lambda kv: -kv[1])[:40])
    print("# spans " + json.dumps(line), flush=True)
    print("# span_metrics " + json.dumps(readings(t, every)), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
