"""Batch generation CLI (:mod:`mmtg_tpu.generate`, reference
``generate.py:149-244``), on the PyTorch port.

Same flags and file-to-file behavior: every test row is replicated
``n_samples`` times and whole batches decode through
:func:`mmtg_tpu_torch.decoding.generate`. The model is what the port's train
CLI wrote (its ``--save_path``, best-val stream first, or one ``step_*.pt``)
or a reference ``.pth`` (Orbax directories are not ported yet); the mesh flags
are accepted for parity and raise unless left at 1.

    python -m mmtg_tpu_torch.generate --data_path test.pkl \\
        --model_path model.pth --tokenizer_path vocab/vocab.txt \\
        --token_emb_path token_id2emb_dict.pkl --n_samples 2 \\
        --save_samples --save_samples_path out.txt
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch

from mmtg_tpu_torch.configs import DataConfig, GenerateConfig, ModelConfig
from mmtg_tpu_torch.utils.logging import setup_logger
from mmtg_tpu_torch.decoding import generate as generate_batch
from mmtg_tpu_torch.decoding import postprocess_tokens
from mmtg_tpu_torch.params import tree_to


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MMTG batch generator (PyTorch)")
    p.add_argument("--device_ids", default="0,1", type=str, help="parity no-op")
    p.add_argument("--CUDA_VISIBLE_DEVICES", default="0,1", type=str,
                   help="parity no-op")
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--num_workers", default=8, type=int, help="parity no-op")
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--model_path", default="", type=str,
                   help="the train CLI's --save_path (train_state_best/ "
                        "preferred, then train_state/), one step_*.pt, or a "
                        "reference .pth / .ckpt / .pt checkpoint")
    p.add_argument("--tokenizer_path", default="", type=str)
    p.add_argument("--token_emb_path", default="./vocab/token_id2emb_dict.pkl",
                   type=str)
    p.add_argument("--temperature", default=1.1, type=float)
    p.add_argument("--topk", default=10, type=int)
    p.add_argument("--topp", default=0.7, type=float)
    p.add_argument("--repetition_penalty", default=1.5, type=float)
    p.add_argument("--n_samples", default=10, type=int)
    p.add_argument("--save_samples", action="store_true")
    p.add_argument("--save_samples_path", default="", type=str)
    p.add_argument("--type_id_scheme", default="train",
                   choices=["train", "reference_infer"])
    p.add_argument("--cache_dtype", default="auto",
                   choices=["auto", "model", "int8", "int4"],
                   help="KV cache precision; 'auto' resolves once per run "
                        "from the nominal decode batch (model at 1, int8 "
                        "above); int4 packs two codes a byte")
    p.add_argument("--merged_kv", action="store_true",
                   help="keep k and v of the int8 cache in one k||v buffer "
                        "(GenerateConfig.merged_kv; per-layer path only)")
    p.add_argument("--weight_dtype", default="auto",
                   choices=["auto", "model", "int8"],
                   help="decode-matmul weight precision; 'auto' resolves "
                        "once per run (int8 when batch_size <= 32)")
    p.add_argument("--topk_impl", default="exact", choices=["exact", "approx"],
                   help="top-k sampling; 'approx' is not ported")
    p.add_argument("--attn_impl", default="auto",
                   choices=["auto", "pallas", "fused", "xla"],
                   help="decode step: 'fused' runs all layers in the "
                        "whole-step kernel (int8 split cache, full-precision "
                        "weights; the per-layer path elsewhere); auto / "
                        "pallas / xla all mean the per-layer path, which "
                        "attends through its CUDA kernel on a GPU and the "
                        "plain version on the CPU")
    p.add_argument("--variant", default="chinese", choices=["chinese", "english"],
                   help="'english' = CLIP embeddings + byte-level-BPE GPT-2; "
                        "--tokenizer_path then points at a directory")
    p.add_argument("--clip_dim", default=512, type=int,
                   help="CLIP embedding width for --variant english")
    p.add_argument("--mesh_data", default=1, type=int,
                   help="parity flag: meshes are not ported (must be 1)")
    p.add_argument("--mesh_model", default=1, type=int,
                   help="parity flag: meshes are not ported (must be 1)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda; pass 'cpu' to run "
                        "without a GPU)")
    return p


def resolve_device(name: str | None) -> torch.device:
    """The CLI's device: ``--device`` when given, else the CUDA card. With
    no card and no ``--device`` this raises rather than run on the CPU
    unasked."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (torch.cuda.is_available() is "
                "False); pass --device cpu to run on the CPU")
        name = "cuda"
    return torch.device(name)


def load_params(model_path: str, mcfg: ModelConfig, device="cpu") -> Dict:
    """The model's parameters from ``--model_path`` on ``device``, as stored
    (a train state's f32 masters like a reference checkpoint's weights): a
    trainer's ``save_path`` (the newest ``step_*.pt`` of
    ``train_state_best/``, else of ``train_state/``; ``FileNotFoundError``
    when neither has one), one ``step_*.pt``, or a reference ``.pth`` /
    ``.ckpt`` / ``.pt``. A file's kind is told by its keys, not its suffix.
    Orbax directories are not ported."""
    from mmtg_tpu_torch.checkpoint import load_model_params, newest_step_file

    return tree_to(load_model_params(newest_step_file(model_path), mcfg), device)


def replicate_batch(rows: List[Dict[str, np.ndarray]], n_samples: int,
                    device) -> Dict[str, torch.Tensor]:
    """Stack test rows, each repeated ``n_samples`` times."""
    keys = ("topic_ids", "tpw_attention_mask", "tpw_type_ids",
            "topic_emb", "img_embs", "r_embs")
    return {
        k: torch.from_numpy(np.repeat(np.stack([r[k] for r in rows]),
                                      n_samples, axis=0)).to(device)
        for k in keys
    }


def main(argv=None, mcfg: ModelConfig | None = None,
         dcfg: DataConfig | None = None) -> None:
    """CLI entry; ``mcfg`` / ``dcfg`` are injectable for small test models."""
    args = build_arg_parser().parse_args(argv)
    if args.mesh_data != 1 or args.mesh_model != 1:
        raise NotImplementedError("mesh decoding is not ported (use "
                                  "--mesh_data 1 --mesh_model 1)")
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.data import MMTGDataset, load_token_embedding_table

    logger = setup_logger()
    device = resolve_device(args.device)
    if mcfg is None or dcfg is None:
        if args.variant == "english":
            from mmtg_tpu_torch.configs import english_variant

            tok = load_tokenizer(args.tokenizer_path)
            mcfg, dcfg = english_variant(clip_dim=args.clip_dim,
                                         gpt2_vocab=len(tok))
        else:
            mcfg, dcfg = ModelConfig(), DataConfig()
    # 'auto' weights / cache resolve ONCE per run from the nominal batch so
    # every batch of the run samples with the same numerics
    weight_dtype = args.weight_dtype
    if weight_dtype == "auto":
        weight_dtype = "int8" if args.batch_size <= 32 else "model"
    cache_dtype = args.cache_dtype
    if cache_dtype == "auto":
        decode_b = max(args.batch_size // args.n_samples, 1) * args.n_samples
        cache_dtype = "model" if decode_b <= 1 else "int8"
    gcfg = GenerateConfig(
        batch_size=args.batch_size, seed=args.seed,
        temperature=args.temperature, top_k=args.topk, top_p=args.topp,
        repetition_penalty=args.repetition_penalty, n_samples=args.n_samples,
        length=dcfg.max_seq_length, type_id_scheme=args.type_id_scheme,
        cache_dtype=cache_dtype, weight_dtype=weight_dtype,
        topk_impl=args.topk_impl, attn_impl=args.attn_impl,
        merged_kv=args.merged_kv,
    )

    tokenizer = load_tokenizer(args.tokenizer_path)
    test_data = MMTGDataset(args.data_path, tokenizer, dcfg, if_train=False)
    logger.info("Data test loaded: %d rows × %d samples", len(test_data),
                args.n_samples)
    if len(test_data) == 0:
        logger.warning("Empty test set %s — nothing to generate.", args.data_path)
        return
    params = load_params(args.model_path, mcfg, device)
    logger.info("Loaded model from %s on %s", args.model_path, device)
    table = torch.from_numpy(load_token_embedding_table(
        args.token_emb_path, len(tokenizer), dcfg.wenlan_emb_size)).to(device)
    const = {"wenlan_table": table}

    rows_per_batch = max(args.batch_size // args.n_samples, 1)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    outputs: List[str] = []
    t0 = time.time()
    tokens_generated = 0
    for lo in range(0, len(test_data), rows_per_batch):
        rows = [test_data[i] for i in range(lo, min(lo + rows_per_batch,
                                                      len(test_data)))]
        n_pad = rows_per_batch - len(rows)  # the final batch keeps its shape
        batch = replicate_batch(rows + [rows[-1]] * n_pad, args.n_samples,
                                device)
        toks = generate_batch(params, const, mcfg, dcfg, gcfg, batch,
                              generator).cpu().numpy()
        tokens_generated += toks.shape[0] * gcfg.length
        for r in range(len(rows) * args.n_samples):
            # one sample per line: byte-level BPE can decode to line breaks
            text = postprocess_tokens(toks[r], tokenizer)
            outputs.append(" ".join(text.splitlines()) if text else text)
    dt = time.time() - t0
    logger.info("Generated %d sequences (%.1f tokens/s) in %.1fs",
                len(outputs), tokens_generated / dt, dt)

    if args.save_samples and args.save_samples_path:
        os.makedirs(os.path.dirname(args.save_samples_path) or ".", exist_ok=True)
        with open(args.save_samples_path, "w", encoding="utf-8") as f:
            for line in outputs:
                f.write(line + "\n")
        logger.info("Wrote %s", args.save_samples_path)
    else:
        for line in outputs[: 3 * args.n_samples]:
            print(line)


if __name__ == "__main__":
    main()
