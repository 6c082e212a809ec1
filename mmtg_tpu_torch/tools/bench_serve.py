"""Service-level serving benchmark of the port (``tools/bench_serve.py`` of
the JAX package).

Measures the window-batching service (:mod:`mmtg_tpu_torch.serve`) end to
end, batcher overhead included, at the full MMTG size in bf16. Two
scenarios:

  * saturation: C closed-loop client threads submit back-to-back for a
    fixed number of requests → sustained tok/s, requests/s, latency
    percentiles, mean realized batch and window fill;
  * solo: single requests to a zero-window service of the smallest bucket
    → the floor latency one isolated user sees (``--solo-runs 0`` skips
    it).

Prints one JSON line per scenario (the JAX tool's keys) and, before each, a
``# service`` comment line: the dtypes and decode step the service's
``auto`` settings resolved to, and its windows a second. Runs on the CUDA
card; ``--device cpu`` runs on the CPU. ``--attn-impl`` (``auto`` /
``kernel`` / ``fused``) is the port's addition; the JAX tool's compilation
cache has no counterpart.

    python -m mmtg_tpu_torch.tools.bench_serve [--clients 64] [--requests 256]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Optional

from mmtg_tpu_torch.tools.serve_common import (Observe, add_port_args,
                                               build_model, emit, make_payload,
                                               scenario, warm_service)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--requests", type=int, default=256,
                    help="total requests in the saturation scenario")
    ap.add_argument("--buckets", default="8,16,32,64", type=str)
    ap.add_argument("--max_wait_ms", type=float, default=25.0)
    ap.add_argument("--cache-dtype", default="int8",
                    choices=["model", "int8", "int4"])
    ap.add_argument("--solo-runs", type=int, default=5)
    add_port_args(ap)
    return ap


def closed_loop(svc, payloads, clients: int) -> tuple:
    """``clients`` threads drain ``payloads`` back-to-back through
    ``generate_sync`` (request ``i`` with seed ``i``) → (wall seconds,
    sorted latencies). A failed request raises here after every thread has
    joined."""
    counter = {"next": 0}
    lock = threading.Lock()
    lat, errors = [], []

    def client():
        while True:
            with lock:
                i = counter["next"]
                if i >= len(payloads):
                    return
                counter["next"] += 1
            t = time.monotonic()
            try:
                svc.generate_sync(payloads[i], seed=i)
            except Exception as e:  # noqa: BLE001 - re-raised after the join
                with lock:
                    errors.append(e)
                return
            with lock:
                lat.append(time.monotonic() - t)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} requests failed") from errors[0]
    return wall, sorted(lat)


def run(args, mcfg=None, dcfg=None, observe: Optional[Observe] = None,
        weights=None) -> dict:
    """Both scenarios → ``{"lines": [saturation, solo], "service": {label:
    facts}}`` (:func:`serve_common.scenario`). ``mcfg`` / ``dcfg`` default
    to the full-size model; ``weights`` = ``(params, const)`` of
    :func:`serve_common.build_model` for them."""
    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.serve import GenerationService

    device = resolve_device(args.device)
    params, const, mcfg, dcfg, gcfg = build_model(
        args.cache_dtype, device, mcfg, dcfg, args.attn_impl, weights=weights)

    def sample(i):
        return make_payload(i, dcfg, mcfg)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    svc = GenerationService(params, const, mcfg, dcfg, gcfg,
                            buckets=buckets, max_wait_ms=args.max_wait_ms)
    svc.start()
    out = {"lines": [], "service": {}}
    try:
        print(f"# warming up buckets {buckets} ...", flush=True)
        t0 = time.perf_counter()
        warm_service(svc)  # this tool sends no stream
        print(f"# warmup done in {time.perf_counter() - t0:.1f}s", flush=True)

        # ---- saturation ---------------------------------------------------
        n_total = args.requests
        # pre-build every request payload: the bench must measure the
        # service, not 2048-wide numpy sample construction inside the
        # client threads
        payloads = [sample(i) for i in range(n_total)]
        with scenario("saturation", svc, out["service"], observe):
            wall, lat = closed_loop(svc, payloads, args.clients)
        st = svc.stats()
    finally:
        svc.stop()
    out["lines"].append(emit({
        "metric": "serving throughput (service-level, %d clients)" % args.clients,
        "value": round(n_total * gcfg.length / wall, 1),
        "unit": "tok/s",
        "detail": {
            "requests": n_total,
            "clients": args.clients,
            "wall_s": round(wall, 2),
            "requests_per_s": round(n_total / wall, 2),
            "p50_latency_s": round(lat[len(lat) // 2], 3),
            "p95_latency_s": round(lat[int(len(lat) * 0.95)], 3),
            "mean_batch": round(st["mean_batch"], 1),
            "batches": st["batches"],
            "mean_fill": round(st["mean_fill"], 3),
            "buckets": list(buckets),
            "max_wait_ms": args.max_wait_ms,
            "cache_dtype": args.cache_dtype,
        },
    }))

    # ---- solo latency --------------------------------------------------------
    # dedicated zero-window service: an isolated user should not pay the
    # saturation config's straggler window
    if args.solo_runs <= 0:
        return out
    solo_svc = GenerationService(params, const, mcfg, dcfg, gcfg,
                                 buckets=(buckets[0],), max_wait_ms=0.0).start()
    solo = []
    try:
        with scenario("solo", solo_svc, out["service"], observe):
            for i in range(args.solo_runs):
                t = time.monotonic()
                solo_svc.generate_sync(sample(10_000 + i), seed=i)
                solo.append(time.monotonic() - t)
    finally:
        solo_svc.stop()
    solo.sort()
    out["lines"].append(emit({
        "metric": "serving solo-request latency (zero-window service)",
        "value": round(solo[len(solo) // 2], 3),
        "unit": "s",
        "detail": {"runs": args.solo_runs,
                   "best_s": round(solo[0], 3),
                   "bucket": buckets[0]},
    }))
    return out


def main(argv=None) -> int:
    run(build_arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
