"""Run one benchmark cell once on the card and print its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up (weights, table and inputs made on
the card from the seed, the kernel library loaded or, in a fresh
checkout, built under ``build/kernels/``, the cell's shapes warmed), then
the timed window of ``--seconds``, then the check against the plain
reference. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. A run on a machine without the card, or with fewer cards than the
cell asks for, exits 1 and prints no result; so does one that finds JAX
or the JAX package loaded when the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    man = harness.manifest()
    w = harness.workload(man, args.workload)
    if not torch.cuda.is_available():
        print("h100bench: no CUDA device: nothing is measured", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < w["chips"]:
        print(f"h100bench: {args.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    rec = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T0, man)
    found = harness.jax_modules()
    if found:
        print(f"h100bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    out = harness.result(man, args.workload, rec, bool(args.trace),
                         torch.cuda.get_device_name(device), w["chips"])
    print("# path " + json.dumps(rec.path), flush=True)
    print("# walls " + json.dumps(rec.walls), flush=True)
    print(f"# check_s {rec.check_s}", flush=True)
    if rec.trace is not None:
        print("# categories_s " + json.dumps(rec.trace["categories_s"]), flush=True)
    print(json.dumps(out), flush=True)
    for k, v in rec.readings.items():
        if k not in rec.checks:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, v in rec.checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
