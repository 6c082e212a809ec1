"""The harness: finds a cell's configuration, traffic mix, limits, driver
and per-layer metrics by the names in ``BENCHMARK.json``, runs the cell,
and builds the result line.

Each piece sits in a file of its own, so a cell, a mix or a metric is
added by adding files:

- ``configs/<config>.json``: ``model`` and ``data`` (the program's
  ``ModelConfig`` / ``DataConfig`` keys), ``source``, ``reduced``,
  ``assumed``;
- ``traffic/<traffic>.json``: its ``kind`` (the driver) and parameters;
- ``limits/<workload>.json``: each compared number's limit, and the
  readings it was set from;
- ``drivers/<kind>.py``: ``run(ctx) -> Record``;
- ``metrics/<metric>.py``: ``UNIT``, ``LAYER``, ``MOVES`` and
  ``read(record) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
JAX_NAMES = ("jax", "jaxlib", "flax", "mmtg_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(known: {[w['name'] for w in man['workloads']]})")


def config(name: str, bench: str = BENCH) -> dict:
    return _json(os.path.join(bench, "configs", f"{name}.json"))


def traffic(name: str, bench: str = BENCH) -> dict:
    return _json(os.path.join(bench, "traffic", f"{name}.json"))


def limits(name: str, bench: str = BENCH) -> dict:
    return _json(os.path.join(bench, "limits", f"{name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench: str = BENCH):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``)."""
    return _module(os.path.join(bench, "metrics", f"{name}.py"),
                   f"h100bench_metric_{name.replace('.', '_').replace('-', '_')}")


def driver(kind: str, bench: str = BENCH):
    return _module(os.path.join(bench, "drivers", f"{kind}.py"),
                   f"h100bench_driver_{kind}")


def model_configs(cfg: dict):
    """The program's ``(ModelConfig, DataConfig)`` of a configuration
    file."""
    from mmtg_tpu_torch.configs import (ChannelConfig, DataConfig, GPT2Config,
                                        ModelConfig)

    m = dict(cfg["model"])
    for ch in ("topic", "image", "text"):
        m[ch] = ChannelConfig(**m[ch])
    m["gpt2"] = GPT2Config(**m["gpt2"])
    return ModelConfig(**m), DataConfig(**cfg["data"])


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    hooks a fault test plants (``faults``: name → wrapper)."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    faults: Dict[str, Callable] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Record:
    """What a driver returns, and what the metric readers read."""

    setup_s: float
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, Dict[str, float]]  # name -> {"value", "limit"}
    correct: bool
    path: Dict[str, Any]
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    walls: List[float] = dataclasses.field(default_factory=list)
    check_s: float = 0.0
    trace: Optional[Dict] = None  # trace.parse of the traced stretch
    work: Dict[str, float] = dataclasses.field(default_factory=dict)


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def judge(readings: Dict[str, float], lims: Dict[str, float]) -> tuple:
    """``(checks, correct)``: each reading that has a limit beside it;
    correct when every one is a number at or under its limit."""
    checks = {k: {"value": float(v), "limit": float(lims[k])}
              for k, v in readings.items() if k in lims}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in checks.values())
    return checks, bool(checks) and ok


def reported_metrics(man: dict, name: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose ``moves`` metric the cell reports."""
    mine = {m["name"] for m in man["end_to_end"]
            if name in m.get("workloads", [name])}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name]) and
            ("workloads" in m or m["moves"] in mine)]


def result(man: dict, name: str, rec: Record, trace: bool, device_kind: str,
           count: int) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and with a trace ``breakdown``), and last the
    compared numbers beside their limits."""
    units = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    metrics = {}
    if trace:
        for m in reported_metrics(man, name):
            v = metric(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for k, v in rec.end_to_end.items():
            metrics[k] = {"value": v, "unit": units[k]}
        metrics["setup_s"] = {"value": rec.setup_s, "unit": units["setup_s"]}
    dev = {"platform": "gpu", "kind": device_kind, "count": count,
           "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        from h100bench import trace as tr

        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = tr.breakdown(rec.trace)
    out["checks"] = rec.checks
    return out


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (compared whole: ``mmtg_tpu_torch`` is not
    ``mmtg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in JAX_NAMES})


def context(name: str, seed: int, seconds: float, trace: bool, device,
            t0: float, man: Optional[dict] = None, faults=None,
            overrides: Optional[dict] = None, bench: str = BENCH) -> Context:
    """The driver's context of cell ``name``. ``overrides`` replace traffic
    parameters (the control's lower precision); ``faults`` are the fault
    tests' hooks."""
    man = man if man is not None else manifest()
    w = workload(man, name)
    tr = dict(traffic(w["traffic"], bench), **(overrides or {}))
    return Context(name, config(w["config"], bench), tr, limits(name, bench),
                   seed, seconds, trace, device, t0, faults or {})


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, man: Optional[dict] = None, faults=None,
             overrides: Optional[dict] = None, bench: str = BENCH) -> Record:
    """Run cell ``name`` once and return its record."""
    ctx = context(name, seed, seconds, trace, device, t0, man, faults,
                  overrides, bench)
    return driver(ctx.traffic["kind"], bench).run(ctx)
