"""Interactive REPL on the PyTorch port (:mod:`mmtg_tpu.predict`, reference
``predict.py:147-272``).

Prompts ``idx>`` for a test-set index and prints the topic and
``n_samples`` sampled lyrics; ``q`` (or end of input) quits. With
``--swap_probe`` it also swaps the image / text embeddings of two experience
steps (``--swap_steps``) and generates again, to show how much the lyrics
depend on the order of the experiences. The same flags as the JAX REPL,
plus ``--device`` (default: the CUDA card; ``cpu`` must be asked for).

The model is what :func:`mmtg_tpu_torch.generate.load_params` reads: the
train CLI's ``--save_path``, one ``step_*.pt``, or a reference ``.pth``.
Every call draws from a threefry key split off the last one
(:mod:`mmtg_tpu_torch.ops.prng`), as the JAX REPL splits its
``jax.random`` key, so ``--seed`` gives the JAX REPL's lyrics in f32.

    printf '0\\nq\\n' | python -m mmtg_tpu_torch.predict --data_path test.pkl \\
        --model_path ckpt --tokenizer_path vocab/vocab.txt \\
        --token_emb_path token_id2emb_dict.pkl --n_samples 2 --swap_probe
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from mmtg_tpu_torch.configs import DataConfig, GenerateConfig, ModelConfig
from mmtg_tpu_torch.decoding import generate as generate_batch
from mmtg_tpu_torch.decoding import postprocess_tokens
from mmtg_tpu_torch.generate import load_params, replicate_batch, resolve_device
from mmtg_tpu_torch.ops import prng


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MMTG interactive REPL (PyTorch)")
    p.add_argument("--device_ids", default="0,1", type=str, help="parity no-op")
    p.add_argument("--batch_size", default=32, type=int, help="parity no-op")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--model_path", default="", type=str,
                   help="the train CLI's --save_path, one step_*.pt, or a "
                        "reference .pth / .ckpt / .pt checkpoint")
    p.add_argument("--tokenizer_path", default="", type=str)
    p.add_argument("--token_emb_path", default="./vocab/token_id2emb_dict.pkl",
                   type=str)
    p.add_argument("--temperature", default=1.1, type=float)
    p.add_argument("--topk", default=10, type=int)
    p.add_argument("--topp", default=0.7, type=float)
    p.add_argument("--repetition_penalty", default=1.5, type=float)
    p.add_argument("--n_samples", default=5, type=int)
    p.add_argument("--cache_dtype", default="auto",
                   choices=["auto", "model", "int8", "int4"])
    p.add_argument("--weight_dtype", default="auto",
                   choices=["auto", "model", "int8"],
                   help="decode-matmul weight precision; 'auto' → int8 at "
                        "REPL batch sizes (n_samples <= 32)")
    p.add_argument("--topk_impl", default="exact", choices=["exact", "approx"],
                   help="top-k sampling; 'approx' takes the exact top-k, as "
                        "lax.approx_max_k does off the TPU")
    p.add_argument("--attn_impl", default="auto",
                   choices=["auto", "pallas", "fused", "xla"],
                   help="decode step: 'fused' runs all layers in the "
                        "whole-step kernel (int8 split cache, full-precision "
                        "weights); the others the per-layer path")
    p.add_argument("--swap_probe", action="store_true",
                   help="also generate with two experience steps swapped")
    p.add_argument("--swap_steps", default="1,3", type=str)
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda; pass 'cpu' to run "
                        "without a GPU)")
    return p


def _swap_steps(row: Dict[str, np.ndarray], i: int, j: int) -> Dict[str, np.ndarray]:
    """A copy of ``row`` with experience steps ``i`` and ``j`` of
    ``img_embs`` and ``r_embs`` swapped."""
    out = {k: np.array(v) for k, v in row.items()}
    for key in ("img_embs", "r_embs"):
        out[key][[i, j]] = out[key][[j, i]]
    return out


def main(argv=None, mcfg: Optional[ModelConfig] = None,
         dcfg: Optional[DataConfig] = None) -> None:
    """REPL entry; ``mcfg`` / ``dcfg`` are injectable for small test models."""
    args = build_arg_parser().parse_args(argv)
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.data import MMTGDataset, load_token_embedding_table

    device = resolve_device(args.device)
    mcfg, dcfg = mcfg or ModelConfig(), dcfg or DataConfig()
    gcfg = GenerateConfig(
        temperature=args.temperature, top_k=args.topk, top_p=args.topp,
        repetition_penalty=args.repetition_penalty, length=dcfg.max_seq_length,
        cache_dtype=args.cache_dtype, weight_dtype=args.weight_dtype,
        topk_impl=args.topk_impl, attn_impl=args.attn_impl)
    tokenizer = load_tokenizer(args.tokenizer_path)
    params = load_params(args.model_path, mcfg, device)
    const = {"wenlan_table": torch.from_numpy(load_token_embedding_table(
        args.token_emb_path, len(tokenizer), dcfg.wenlan_emb_size)).to(device)}
    test_data = MMTGDataset(args.data_path, tokenizer, dcfg, if_train=False)
    print(f"Loaded {len(test_data)} test rows. Enter an index (or 'q' to quit).")

    key = prng.PRNGKey(args.seed, device=device)
    swap_i, swap_j = (int(x) for x in args.swap_steps.split(","))

    def show(row, label):
        nonlocal key
        key, sub = prng.split(key)
        batch = replicate_batch([row], args.n_samples, device)
        toks = generate_batch(params, const, mcfg, dcfg, gcfg, batch,
                              sub).cpu().numpy()
        for r in range(args.n_samples):
            print(f"  [{label} {r}] {postprocess_tokens(toks[r], tokenizer)}")

    while True:
        try:
            raw = input("idx> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if raw.lower() in ("q", "quit", "exit"):
            break
        if not raw.isdigit() or int(raw) >= len(test_data):
            print(f"Please enter an index in [0, {len(test_data)}).")
            continue
        idx = int(raw)
        row = test_data[idx]
        print(f"topic: {test_data.topics[idx]}")
        show(row, "sample")
        if args.swap_probe:
            print(f"— swap probe: steps {swap_i} ↔ {swap_j} —")
            show(_swap_steps(row, swap_i, swap_j), "swapped")


if __name__ == "__main__":
    main()
