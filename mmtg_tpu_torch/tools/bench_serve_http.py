"""HTTP-front serving benchmark of the port (``tools/bench_serve_http.py`` of
the JAX package).

:mod:`~mmtg_tpu_torch.tools.bench_serve` measures the window-batching
service at the Python API; this tool measures the whole production path —
HTTP parse, request decode (JSON against binary npz), the service, the JSON
response — with keep-alive ``http.client`` connections, so the difference
to the service-level number is the transport and encoding cost a deployment
pays. Every body is encoded before the clock starts.

Per encoding it reports sustained tok/s, requests/s, latency percentiles
and the request body's size. It then holds every response's tokens against
``submit`` of the same sample and seed on the same service, and a mismatch
exits non-zero. That holds for any bucket menu: a response does not depend
on the bucket its window was padded to, nor on the rows beside it (the
service's batch-composition invariance; on the card the decode's products
and reductions whose order cuBLAS and PyTorch would set by the batch go
through the port's batch-invariant kernels, ``ops/matmul``, ``ops/cumsum``),
so which window a request took does not matter.

Prints one JSON line per encoding (the JAX tool's keys) after a ``# service``
comment line. Runs on the CUDA card; ``--device cpu`` runs on the CPU;
``--attn-impl`` is the port's addition; the JAX tool's compilation cache has
no counterpart.

    python -m mmtg_tpu_torch.tools.bench_serve_http [--clients 64] [--requests 256]
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
from typing import Optional

import numpy as np

from mmtg_tpu_torch.tools.serve_common import (Observe, add_port_args,
                                               build_model, emit, make_payload,
                                               scenario, warm_service)


def _encode_json(sample: dict, seed: int) -> tuple:
    body = json.dumps({
        "sample": {k: np.asarray(v).tolist() for k, v in sample.items()},
        "seed": seed,
        "text": False,
    }).encode()
    return body, "application/json"


def _encode_npz(sample: dict, seed: int) -> tuple:
    from mmtg_tpu_torch.serve import NPZ_CONTENT_TYPE, encode_request_npz

    return encode_request_npz(sample, seed=seed, text=False), NPZ_CONTENT_TYPE


def run_scenario(port: int, payloads: list, encoding: str, clients: int,
                 gen_len: int, extra: dict) -> tuple:
    """Closed-loop: ``clients`` threads with keep-alive connections drain
    the shared payload list back-to-back (request ``i`` with seed ``i``) →
    (the result line, each request's tokens or ``None`` where it failed)."""
    enc = _encode_json if encoding == "json" else _encode_npz
    t_enc0 = time.perf_counter()
    bodies = [enc(p, i) for i, p in enumerate(payloads)]
    encode_s = time.perf_counter() - t_enc0

    counter = {"next": 0}
    lock = threading.Lock()
    lat: list = []
    errors: list = []
    tokens: list = [None] * len(bodies)

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            while True:
                with lock:
                    i = counter["next"]
                    if i >= len(bodies):
                        return
                    counter["next"] += 1
                body, ctype = bodies[i]
                t = time.monotonic()
                conn.request("POST", "/generate", body=body,
                             headers={"Content-Type": ctype})
                resp = conn.getresponse()
                data = resp.read()
                dt = time.monotonic() - t
                with lock:
                    if resp.status != 200:
                        errors.append((resp.status, data[:200]))
                    else:
                        lat.append(dt)
                        tokens[i] = json.loads(data)["tokens"]
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat.sort()
    n_ok = len(lat)
    return {
        "metric": f"HTTP serving throughput ({encoding}, {clients} clients)",
        "value": round(n_ok * gen_len / wall, 1),
        "unit": "tok/s",
        "detail": {
            "requests_ok": n_ok,
            "errors": len(errors),
            "first_error": errors[0][1].decode("utf-8", "replace")
            if errors else None,
            "wall_s": round(wall, 2),
            "requests_per_s": round(n_ok / wall, 2),
            "p50_latency_s": round(lat[n_ok // 2], 3) if n_ok else None,
            "p95_latency_s": round(lat[int(n_ok * 0.95)], 3) if n_ok else None,
            "payload_bytes": len(bodies[0][0]),
            "client_encode_ms_per_req": round(
                encode_s / len(bodies) * 1e3, 2),
            **extra,
        },
    }, tokens


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--requests", type=int, default=256,
                    help="requests per encoding scenario")
    ap.add_argument("--buckets", default="8,16,32,64", type=str)
    ap.add_argument("--max_wait_ms", type=float, default=25.0)
    ap.add_argument("--cache-dtype", default="int8",
                    choices=["model", "int8", "int4"])
    ap.add_argument("--encodings", default="json,npz", type=str)
    add_port_args(ap)
    return ap


def run(args, mcfg=None, dcfg=None, observe: Optional[Observe] = None,
        weights=None) -> dict:
    """Every encoding → ``{"lines": [...], "service": {encoding: facts},
    "tokens_checked": bool}``; the arguments as :func:`mmtg_tpu_torch.tools.bench_serve.run`'s."""
    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.serve import GenerationService, serve_http

    device = resolve_device(args.device)
    params, const, mcfg, dcfg, gcfg = build_model(
        args.cache_dtype, device, mcfg, dcfg, args.attn_impl, weights=weights)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    svc = GenerationService(params, const, mcfg, dcfg, gcfg,
                            buckets=buckets, max_wait_ms=args.max_wait_ms)
    svc.start()
    httpd = None
    out = {"lines": [], "service": {}}
    try:
        print(f"# warming up buckets {buckets} ...", flush=True)
        t0 = time.perf_counter()
        warm_service(svc)  # this tool sends no stream
        print(f"# warmup done in {time.perf_counter() - t0:.1f}s", flush=True)

        httpd = serve_http(svc, port=0)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        payloads = [make_payload(i, dcfg, mcfg) for i in range(args.requests)]
        extra = {"buckets": list(buckets), "max_wait_ms": args.max_wait_ms,
                 "cache_dtype": args.cache_dtype}
        answers = {}
        out["tokens_checked"] = False
        for encoding in args.encodings.split(","):
            encoding = encoding.strip()
            with scenario(encoding, svc, out["service"], observe):
                line, answers[encoding] = run_scenario(
                    port, payloads, encoding, args.clients, gcfg.length, extra)
            out["lines"].append(emit(line))
        # every response against the service's own answer to the same
        # (sample, seed), submitted together
        futs = [svc.submit(p, seed=i) for i, p in enumerate(payloads)]
        want = [f.result(timeout=600) for f in futs]
        for encoding, got in answers.items():
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if g is None or not np.array_equal(np.asarray(g), w)]
            if bad:
                raise SystemExit(f"{encoding}: {len(bad)} responses differ from "
                                 f"submit() with the same seed (first: "
                                 f"request {bad[0]})")
        out["tokens_checked"] = True
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        svc.stop()
    return out


def main(argv=None) -> int:
    run(build_arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
