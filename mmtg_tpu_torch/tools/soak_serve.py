"""Serving soak of the port (``tools/soak_serve.py`` of the JAX package):
open-loop Poisson traffic against the window-batching service, with
periodic stats snapshots.

Unlike :mod:`~mmtg_tpu_torch.tools.bench_serve`'s closed-loop clients (which
can never overload the service: each client waits for its reply), this
drives OPEN-LOOP arrivals at a fixed rate from ``--producers`` threads, the
regime where backlog growth, latency drift, stats-counter leaks or
collector stalls would show. Past ``--max_queue_depth`` queued requests
``submit`` raises ``ServiceOverloaded``: such rejections are counted, not
failures. Snapshots report PER-INTERVAL latency percentiles (a cumulative
median would mask late-run drift) and the backlog (submitted, not yet
resolved). The run ends with a drain and a summary whose ``ok`` requires no
lost reply, no failed future, no service error, at least one request done,
and both service threads ended after ``stop()``.

Prints one JSON snapshot line per interval and a final summary (the JAX
tool's keys) after a ``# service`` comment line; exits non-zero when ``ok``
is false. Runs on the CUDA card; ``--device cpu`` runs on the CPU;
``--attn-impl`` is the port's addition; the JAX tool's compilation cache
has no counterpart.

    python -m mmtg_tpu_torch.tools.soak_serve --rate 300 --duration_s 600
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Optional

import numpy as np

from mmtg_tpu_torch.tools.serve_common import (Observe, add_port_args,
                                               build_model, emit, make_payload,
                                               scenario, warm_service)


def _pct(sorted_vals, q):
    return round(sorted_vals[min(len(sorted_vals) - 1,
                                 int(len(sorted_vals) * q))], 3)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rate", type=float, default=300.0,
                    help="mean arrivals/s over all producers")
    ap.add_argument("--producers", type=int, default=1,
                    help="arrival threads (one thread's sleep-and-submit "
                         "loop caps its rate; use several to reach or "
                         "exceed the service's capacity)")
    ap.add_argument("--duration_s", type=float, default=600.0)
    ap.add_argument("--snapshot_every_s", type=float, default=30.0)
    ap.add_argument("--buckets", default="8,32,128", type=str)
    ap.add_argument("--max_wait_ms", type=float, default=40.0)
    ap.add_argument("--cache-dtype", default="int8",
                    choices=["model", "int8", "int4"])
    ap.add_argument("--max_queue_depth", type=int, default=4096)
    add_port_args(ap)
    return ap


def run(args, mcfg=None, dcfg=None, observe: Optional[Observe] = None,
        weights=None) -> dict:
    """The soak → ``{"lines": [snapshots..., summary], "service": {"soak":
    facts}}``; the arguments as :func:`mmtg_tpu_torch.tools.bench_serve.
    run`'s."""
    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.serve import GenerationService, ServiceOverloaded

    device = resolve_device(args.device)
    params, const, mcfg, dcfg, gcfg = build_model(
        args.cache_dtype, device, mcfg, dcfg, args.attn_impl, weights=weights)
    # a small pool of pre-built payloads (arrival loop must be cheap)
    pool = [make_payload(i, dcfg, mcfg) for i in range(64)]

    buckets = tuple(int(b) for b in args.buckets.split(","))
    svc = GenerationService(params, const, mcfg, dcfg, gcfg,
                            buckets=buckets, max_wait_ms=args.max_wait_ms,
                            max_queue_depth=args.max_queue_depth)
    svc.start()
    workers = (svc._thread, svc._collector)
    print("# warming up ...", flush=True)
    warm_service(svc)  # this tool sends no stream

    lock = threading.Lock()
    state = {"submitted": 0, "done": 0, "failed": 0, "rejected": 0}
    all_lats: list = []       # summary percentiles (sorted at END)
    interval_lats: list = []  # reset per snapshot — shows drift

    def on_done(t0):
        def cb(fut):
            dt = time.monotonic() - t0
            with lock:
                if fut.exception() is None:
                    state["done"] += 1
                    all_lats.append(dt)
                    interval_lats.append(dt)
                else:
                    state["failed"] += 1
        return cb

    stop = threading.Event()

    def producer(pid):
        arr_rng = np.random.default_rng(1234 + pid)
        i = pid * 10_000_000
        per_thread_rate = args.rate / args.producers
        while not stop.is_set():
            time.sleep(float(arr_rng.exponential(1.0 / per_thread_rate)))
            t0 = time.monotonic()
            try:
                fut = svc.submit(pool[i % len(pool)], seed=i)
            except ServiceOverloaded:
                with lock:
                    state["rejected"] += 1
            else:
                with lock:
                    state["submitted"] += 1
                fut.add_done_callback(on_done(t0))
            i += 1

    prods = [threading.Thread(target=producer, args=(p,), daemon=True)
             for p in range(args.producers)]
    out = {"lines": [], "service": {}}
    try:
        with scenario("soak", svc, out["service"], observe):
            # t_start is POST-warmup: both tokens_served and the wall clock
            # then cover only soak traffic
            t_start = time.monotonic()
            for prod in prods:
                prod.start()
            max_backlog = 0
            last_tokens = 0
            while True:
                remaining = args.duration_s - (time.monotonic() - t_start)
                if remaining <= 0:
                    break
                time.sleep(min(args.snapshot_every_s, remaining))
                with lock:
                    snap = dict(state)
                    lat = interval_lats
                    interval_lats = []
                lat.sort()  # outside the lock: the done-callbacks (which run
                # in the service collector thread) must never wait on a sort
                st = svc.stats()
                now = time.monotonic()
                backlog = snap["submitted"] - snap["done"] - snap["failed"]
                max_backlog = max(max_backlog, backlog)
                out["lines"].append(emit({
                    "t_s": round(now - t_start, 1),
                    **snap,
                    "backlog": backlog,
                    "mean_batch": round(st["mean_batch"], 1),
                    "tokens_per_s": round(
                        st["tokens_served"] / max(now - t_start, 1e-9), 1
                    ),
                    "interval_tokens_per_s": round(
                        (st["tokens_served"] - last_tokens)
                        / max(args.snapshot_every_s, 1e-9), 1
                    ),
                    "interval_p50_s": _pct(lat, 0.5) if lat else None,
                    "interval_p99_s": _pct(lat, 0.99) if lat else None,
                }))
                last_tokens = st["tokens_served"]
            stop.set()
            for prod in prods:
                prod.join()
            actual_duration = time.monotonic() - t_start
            # drain: everything submitted must resolve
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                with lock:
                    if state["done"] + state["failed"] >= state["submitted"]:
                        break
                time.sleep(0.05)
    finally:
        stop.set()
        svc.stop()
    stopped = not any(t.is_alive() for t in workers)
    with lock:
        snap = dict(state)
        lat = list(all_lats)
    lat.sort()
    st = svc.stats()
    lost = snap["submitted"] - snap["done"] - snap["failed"]
    out["lines"].append(emit({
        "metric": "serving soak",
        "ok": bool(lost == 0 and snap["failed"] == 0
                   and st["errors"] == 0 and snap["done"] > 0 and stopped),
        "duration_s": round(actual_duration, 1),
        "requested_duration_s": args.duration_s,
        "rate_req_s": args.rate,
        **snap,
        "lost": lost,
        "max_backlog": max_backlog,
        "service_errors": st["errors"],
        "tokens_served": st["tokens_served"],
        "tokens_per_s": round(st["tokens_served"] / actual_duration, 1),
        "p50_s": _pct(lat, 0.5) if lat else None,
        "p95_s": _pct(lat, 0.95) if lat else None,
        "p99_s": _pct(lat, 0.99) if lat else None,
        "mean_batch": round(st["mean_batch"], 1),
    }))
    return out


def main(argv=None) -> int:
    out = run(build_arg_parser().parse_args(argv))
    return 0 if out["lines"][-1]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
