"""Readings that set a cell's limits, taken on the card at the cell's own
size: the control (the computation in the precision below the one the
configuration states) and the planted faults. The benchmark's own runs
never run these.

    python3 h100bench/control.py --workload <name> --what <kind> \
        --seeds <n> ... [--seconds <s>]

``--what``:

- ``program``: the sound program, through the cell's window and check
  (the readings the lower end of each limit is taken from);
- ``control``: a generate cell runs the program's own lower-precision path
  (int8 weights, int4 cache) through the cell's window and check; the
  training cell puts the reference in the program's place with float8
  products and compares it with the float32 reference.
- ``token`` / ``half`` (generate) and ``half`` / ``unchanged`` (train):
  the program with a fault planted (a token altered where it is produced;
  half of the batch left out; a step that leaves its state unchanged).

One line of JSON a seed: its readings (those the cell compares, and the
others its check takes).
"""

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOWER = {"cache_dtype": "int4", "weight_dtype": "int8"}


def altered_token(generate):
    """A fault: each row's token at step 4 is replaced by the next id."""
    def call(params, const, mcfg, dcfg, gcfg, batch, gen):
        toks = generate(params, const, mcfg, dcfg, gcfg, batch, gen)
        toks[:, 5] = (toks[:, 5] + 1) % mcfg.gpt2.vocab_size
        return toks
    return call


def half_rows(generate):
    """A fault: the second half of the rows never decoded ([PAD])."""
    def call(params, const, mcfg, dcfg, gcfg, batch, gen):
        toks = generate(params, const, mcfg, dcfg, gcfg, batch, gen)
        toks[toks.shape[0] // 2:, 1:] = 0
        return toks
    return call


def half_batch(step):
    """A fault: the step sees the first half of the rows, its mean taken
    over them."""
    def call(state, const, batch, stage):
        n = next(iter(batch.values())).shape[0] // 2
        return step(state, const, {k: v[:n] for k, v in batch.items()}, stage)
    return call


def unchanged(step):
    """A fault: the step computes its loss, then leaves the parameters and
    the optimizer's state as they were."""
    from mmtg_tpu_torch.params import tree_leaves

    def call(state, const, batch, stage):
        kept = tree_leaves(state.params) + tree_leaves(state.opt_state)
        before = [t.detach().clone() for t in kept]
        new, metrics = step(state, const, batch, stage)
        import torch

        with torch.no_grad():
            for t, b in zip(kept, before):
                t.copy_(b)
        return new._replace(params=state.params, opt_state=state.opt_state), metrics
    return call


FAULTS = {"token": {"generate": altered_token},
          "half": {"generate": half_rows, "step": half_batch},
          "unchanged": {"step": unchanged}}


def fault_hooks(what: str, kind: str) -> dict:
    """The hooks of fault ``what`` for a driver of ``kind``."""
    key = "generate" if kind == "generate" else "step"
    if key not in FAULTS[what]:
        raise ValueError(f"fault {what!r} has no form for a {kind} cell")
    import mmtg_tpu_torch.decoding as decoding

    hook = FAULTS[what][key]
    return {"generate": hook(decoding.generate)} if key == "generate" else {"step": hook}


def readings(name: str, what: str, seed: int, seconds: float, device,
             t0: float, man=None, bench=None) -> dict:
    """The readings of one seed under ``what``."""
    from h100bench import harness

    bench = bench or harness.BENCH
    man = man if man is not None else harness.manifest()
    kind = harness.traffic(harness.workload(man, name)["traffic"], bench)["kind"]
    if what == "control" and kind == "train":
        drv = harness.driver("train", bench)
        ctx = harness.context(name, seed, seconds, False, device, t0, man,
                              bench=bench)
        return drv.control_readings(ctx)
    if what in ("program", "control"):
        rec = harness.run_cell(name, seed, seconds, False, device, t0, man,
                               overrides=LOWER if what == "control" else None,
                               bench=bench)
    else:
        rec = harness.run_cell(name, seed, seconds, False, device, t0, man,
                               faults=fault_hooks(what, kind), bench=bench)
    return dict(rec.readings, worst=rec.path.get("worst"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True,
                    choices=["program", "control", "token", "half", "unchanged"])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        r = readings(args.workload, args.what, seed, args.seconds, dev,
                     time.perf_counter())
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed, "readings": r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
