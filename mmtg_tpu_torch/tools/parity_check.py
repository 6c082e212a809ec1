"""One-command logits check of the port on a reference-format ``.pth``
(``scripts/parity_check.py`` of the JAX package).

The ``.pth`` (``{'model': state dict}``, the ``module.`` prefix handled) is
loaded into the port through
:func:`mmtg_tpu_torch.checkpoint.load_reference_checkpoint`; with
``--make-synthetic-ckpt PATH`` a random full-size one is written there first
and checked. Fixture batches of ``--data`` (a reference-schema pkl, as
``tools/make_fixtures.py`` writes) go through three surfaces
(``--branch train|infer|decode|all``), as in the JAX tool:

* ``train``: the teacher-forced train forward (``mmtg_forward_train``,
  dropout off), ``--max_batches`` batches of ``--batch_size``;
* ``infer``: the no-cache inference forward (``mmtg_forward_infer``, the
  reference's per-sentence type ids) on one row's first ``--decode_prefix``
  target tokens;
* ``decode``: the KV-cached decode steps under teacher forcing
  (``decoding.teacher_forced_decode_logits``) against re-forwards of each
  prefix.

The subject runs on ``--device`` (the card by default) through the port's
kernels in f32, and again in bf16, reported beside; the yardstick is the
port's plain path on the CPU in f32 (the CPU tests hold that path to the JAX
package). The JAX tool's ``--oracle`` (its rebuilt torch model, or the
reference's own ``model.py``) has no counterpart. It prints one JSON line
with the max-abs logits difference of each surface and exits 1 when an f32
one passes ``--atol`` (5e-4, the JAX tool's).

    python -m mmtg_tpu_torch.tools.parity_check --make-synthetic-ckpt /tmp/c.pth \\
        --ckpt /tmp/c.pth --data val.pkl --vocab vocab/vocab.txt \\
        --token_emb_path token_id2emb_dict.pkl [--branch all] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True, help="reference-format .pth")
    p.add_argument("--data", required=True, help="test/val pkl (reference schema)")
    p.add_argument("--vocab", default="vocab/vocab.txt")
    p.add_argument("--token_emb_path", default="vocab/token_id2emb_dict.pkl")
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--max_batches", default=2, type=int)
    p.add_argument("--atol", default=5e-4, type=float,
                   help="max-abs f32 logits difference to accept")
    p.add_argument("--branch", default="all",
                   choices=["train", "infer", "decode", "all"])
    p.add_argument("--decode_prefix", default=26, type=int,
                   help="prefix length for the infer and decode checks")
    p.add_argument("--make-synthetic-ckpt", default="",
                   help="first write a random reference-format .pth here "
                        "(the model's full size) so the check can self-demo")
    p.add_argument("--device", default="cuda",
                   help="where the subject runs (cuda; 'cpu' runs it on the CPU)")
    return p


def _to(batch: Dict, device, dtype=None) -> Dict:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)).to(device)
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return out


def _tree(params, device, dtype):
    from mmtg_tpu_torch.params import tree_to

    return tree_to(params, device, dtype)


def surfaces(params: Dict, table: np.ndarray, batches, infer_batch: Dict,
             mcfg, dcfg, branch: str, prefix: int, device, dtype,
             reforward: bool = False) -> Dict:
    """The logits of each surface of ``branch`` on ``device`` in ``dtype``
    (numpy f32): ``{"train": [per batch [B, L, V]], "infer": [1, K, V],
    "decode": [1, K, V]}`` and, with ``reforward``, ``"reforward": {prefix
    length j: [1, V]}`` (the decode surface's yardstick). On the CPU every
    kernel runs its plain version."""
    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import teacher_forced_decode_logits
    from mmtg_tpu_torch.models.mmtg import mmtg_forward_infer, mmtg_forward_train

    p = _tree(params, device, dtype)
    const = {"wenlan_table": torch.as_tensor(table).to(device, dtype)}
    out = {}
    with torch.no_grad():
        if branch in ("train", "all"):
            out["train"] = [
                mmtg_forward_train(p, const, mcfg, dcfg, _to(b, device, dtype),
                                   deterministic=True).logits.float().cpu().numpy()
                for b in batches]
        if branch in ("infer", "decode", "all"):
            jb = _to(infer_batch, device, dtype)
            tokens = _prefix_tokens(infer_batch, prefix).to(device)
            if branch in ("infer", "all"):
                out["infer"] = mmtg_forward_infer(
                    p, const, mcfg, dcfg, dict(jb, targets=tokens),
                    type_id_scheme="reference_infer").logits.float().cpu().numpy()
            if branch in ("decode", "all"):
                gcfg = GenerateConfig(type_id_scheme="reference_infer")
                out["decode"] = teacher_forced_decode_logits(
                    p, const, mcfg, dcfg, gcfg, jb, tokens).float().cpu().numpy()
            if branch in ("decode", "all") and reforward:
                out["reforward"] = {
                    j + 1: mmtg_forward_infer(
                        p, const, mcfg, dcfg, dict(jb, targets=tokens[:, :j + 1]),
                        type_id_scheme="reference_infer").logits[:, -1].float().cpu().numpy()
                    for j in _decode_prefixes(prefix)}
    return out


def _prefix_tokens(batch: Dict, prefix: int) -> torch.Tensor:
    """The row's first ``prefix`` target tokens, a bare ``[#START#]`` first
    (as generation seeds it)."""
    K = max(2, prefix)
    tokens = np.asarray(batch["targets"])[:, :K].copy()
    tokens[:, 0] = 1
    return torch.as_tensor(tokens)


def _decode_prefixes(prefix: int):
    K = max(2, prefix)
    return range(0, K, max(K // 6, 1))


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def compare(subject: Dict, ref: Dict) -> Dict:
    """Max-abs differences of each surface of ``subject`` against ``ref``;
    the decode steps against the reference's re-forwards of each prefix."""
    rep = {}
    if "train" in subject:
        per = [_max_abs(a, b) for a, b in zip(subject["train"], ref["train"])]
        rep["train"] = {"max_abs_logits_diff": max(per), "per_batch": per}
    if "infer" in subject:
        rep["infer"] = {"max_abs_logits_diff": _max_abs(subject["infer"], ref["infer"])}
    if "decode" in subject:
        per = {j: _max_abs(subject["decode"][:, j - 1], r)
               for j, r in ref["reforward"].items()}
        rep["decode"] = {"max_abs_logits_diff": max(per.values()),
                         "per_prefix": {str(j): d for j, d in per.items()}}
    return rep


def load_inputs(args, mcfg, dcfg):
    """(params, WenLan table, batches, one row's batch) of ``args``: the
    ``.pth`` through ``load_reference_checkpoint`` (written first with
    ``--make-synthetic-ckpt``), ``--max_batches`` batches of ``--data``."""
    from mmtg_tpu_torch.checkpoint import load_reference_checkpoint, save_reference_checkpoint
    from mmtg_tpu_torch.data import MMTGDataset, load_token_embedding_table
    from mmtg_tpu_torch.params import init_params
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    if args.make_synthetic_ckpt:
        save_reference_checkpoint(args.make_synthetic_ckpt,
                                  init_params(mcfg, seed=0), mcfg)
        print(f"wrote synthetic reference-format ckpt: {args.make_synthetic_ckpt}",
              file=sys.stderr)
    params = load_reference_checkpoint(args.ckpt, mcfg)
    tokenizer = WordPieceTokenizer.from_file(args.vocab)
    table = load_token_embedding_table(args.token_emb_path, len(tokenizer),
                                       dcfg.wenlan_emb_size)
    ds = MMTGDataset(args.data, tokenizer, dcfg, if_train=False)
    batches = []
    for i, b in enumerate(ds.batches(args.batch_size)):
        if i >= args.max_batches:
            break
        b.pop("sample_mask", None)
        batches.append(b)
    one = next(ds.batches(1))
    one.pop("sample_mask", None)
    return params, table, batches, one


def run(args, mcfg=None, dcfg=None) -> Dict:
    """The check at ``args`` (``mcfg`` / ``dcfg``: another model
    configuration); returns the report printed by :func:`main`."""
    from mmtg_tpu_torch.configs import DataConfig, ModelConfig

    mcfg = mcfg or ModelConfig()
    dcfg = dcfg or DataConfig()
    params, table, batches, one = load_inputs(args, mcfg, dcfg)
    where = dict(mcfg=mcfg, dcfg=dcfg, branch=args.branch, prefix=args.decode_prefix)
    ref = surfaces(params, table, batches, one, device="cpu", dtype=torch.float32,
                   reforward=True, **where)
    rep = {"ckpt": args.ckpt, "atol": args.atol, "device": args.device,
           "yardstick": "the port's plain path on the CPU, float32"}
    if args.device != "cpu":
        rep["device_name"] = torch.cuda.get_device_name(torch.device(args.device))
    worst = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        sub = surfaces(params, table, batches, one, device=args.device, dtype=dtype, **where)
        rep[name] = compare(sub, ref)
        worst[name] = max(v["max_abs_logits_diff"] for v in rep[name].values())
    rep["max_abs_logits_diff"] = worst["float32"]
    rep["bfloat16_max_abs_logits_diff"] = worst["bfloat16"]
    rep["ok"] = worst["float32"] <= args.atol
    return rep


def main(argv=None, mcfg=None, dcfg=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("parity_check: no CUDA device (--device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    rep = run(args, mcfg, dcfg)
    print(json.dumps(rep))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
