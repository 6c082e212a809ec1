"""Deterministic demo / test fixtures for the port (``scripts/make_fixtures.py``
of the JAX package), so a fresh clone runs the train → generate → evaluate
loop with no external data.

Writes (all seeded, reproducible; the same files, records and table as the
JAX script):
  data/train_data_with_ratings.pkl  (32 rated records)
  data/val_data_with_ratings.pkl    (8 rated records)
  data/final_test.pkl               (4 unrated records)
  vocab/token_id2emb_dict.pkl       ({token_id: [2048 floats]} side table,
                                     reference model.py:221-223 schema,
                                     ~109MB — generated, never committed)

The records are ``mmtg_tpu_torch.data.make_synthetic_records`` drawn from
``default_rng(seed)``; the table from ``default_rng(seed + 1)``. Real-data
users point the CLIs at their own pkls instead.

    python -m mmtg_tpu_torch.tools.make_fixtures [--root .] [--skip-emb-table]
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=".", help="repo root to write under")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--skip-emb-table", action="store_true",
                   help="skip the ~109MB token_id2emb_dict.pkl")
    p.add_argument("--vocab_size", default=13317, type=int)
    p.add_argument("--emb_size", default=2048, type=int)
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from mmtg_tpu_torch.data import make_synthetic_records

    rng = np.random.default_rng(args.seed)
    data_dir = os.path.join(args.root, "data")
    os.makedirs(data_dir, exist_ok=True)

    for name, n, train in [
        ("train_data_with_ratings.pkl", 32, True),
        ("val_data_with_ratings.pkl", 8, True),
        ("final_test.pkl", 4, False),
    ]:
        recs = make_synthetic_records(n, rng, emb_size=args.emb_size)
        if not train:
            for r in recs:
                r.pop("rating", None)
        path = os.path.join(data_dir, name)
        with open(path, "wb") as f:
            pickle.dump(recs, f)
        print(f"wrote {path} ({n} records)")

    if not args.skip_emb_table:
        out = os.path.join(args.root, "vocab", "token_id2emb_dict.pkl")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        emb_rng = np.random.default_rng(args.seed + 1)
        table = {
            i: emb_rng.standard_normal(args.emb_size).astype(np.float32)
            for i in range(args.vocab_size)
        }
        with open(out, "wb") as f:
            pickle.dump(table, f)
        print(f"wrote {out} ({args.vocab_size} x {args.emb_size})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
