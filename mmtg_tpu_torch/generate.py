"""Batch generation CLI (:mod:`mmtg_tpu.generate`, reference
``generate.py:149-244``), on the PyTorch port.

Same flags and file-to-file behavior: every test row is replicated
``n_samples`` times and whole batches decode through
:func:`mmtg_tpu_torch.decoding.generate`. The model is what the port's train
CLI wrote (its ``--save_path``, best-val stream first, or one ``step_*.pt``)
or a reference ``.pth`` (a JAX run's Orbax directory is converted first by
``scripts/orbax_to_torch.py``).

    python -m mmtg_tpu_torch.generate --data_path test.pkl \\
        --model_path model.pth --tokenizer_path vocab/vocab.txt \\
        --token_emb_path token_id2emb_dict.pkl --n_samples 2 \\
        --save_samples --save_samples_path out.txt

Over a ``(data, model)`` mesh, every rank started by ``torchrun``
(``python -m torch.distributed.run --nproc_per_node N -m
mmtg_tpu_torch.generate ... --mesh_data D --mesh_model M``; ``--mesh_data 0``
= N / M): batches decode through
:func:`mmtg_tpu_torch.decoding.generate_sharded` with one threefry stream
per sample, keyed on ``--seed`` and the sample's global index (as the JAX
CLI), so the samples do not depend on the mesh's shape; rank 0 alone
writes them.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from mmtg_tpu_torch.configs import DataConfig, GenerateConfig, ModelConfig
from mmtg_tpu_torch.utils.logging import setup_logger
from mmtg_tpu_torch.decoding import generate as generate_batch
from mmtg_tpu_torch.decoding import generate_sharded, postprocess_tokens
from mmtg_tpu_torch.ops import prng
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
                   help="top-k sampling; 'approx' takes the exact top-k, as "
                        "lax.approx_max_k does off the TPU")
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
                   help="data-parallel size of the (data, model) mesh, under "
                        "torchrun; 0 = the world size / --mesh_model")
    p.add_argument("--mesh_model", default=1, type=int,
                   help="tensor-parallel size of the mesh, under torchrun")
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


def mesh_from_args(args, device: torch.device):
    """``(mesh, device)`` of ``--mesh_data`` / ``--mesh_model``: ``(None,
    device)`` for the default ``(1, 1)``; else this rank joins the job
    ``torchrun`` started (:func:`mmtg_tpu_torch.parallel.mesh.
    init_distributed`: its card, or the CPU, and the backend the rule picks,
    which is logged) and the mesh is made. Without a launcher it raises."""
    from mmtg_tpu_torch.parallel import mesh as pmesh

    if (args.mesh_data, args.mesh_model) == (1, 1):
        return None, device
    if not torch.distributed.is_initialized() and "RANK" not in os.environ:
        raise RuntimeError(f"--mesh_data {args.mesh_data} --mesh_model "
                           f"{args.mesh_model}: a mesh needs one process a rank; "
                           f"{pmesh.LAUNCH_HINT}")
    info = pmesh.init_distributed(device)
    dp = args.mesh_data or max(info.world_size // args.mesh_model, 1)
    mesh = pmesh.make_mesh((dp, args.mesh_model), info.device)
    setup_logger().info("rank %d of %d on %s, backend %s, mesh (data %d, "
                        "model %d)", info.rank, info.world_size, info.device,
                        info.backend, dp, args.mesh_model)
    return mesh, info.device


def resolve_run_dtypes(args, meshed: bool = False) -> Tuple[str, str, int]:
    """``(cache dtype, weight dtype, decode batch)`` of a run's parsed flags.
    'auto' resolves ONCE per run from the nominal batch, so every batch of
    the run samples with the same numerics: int8 weights while
    ``--batch_size`` <= 32, an int8 cache once the decode batch
    (``batch_size // n_samples * n_samples``) passes 1 on one device (any
    meshed run keeps the model dtype: resolve_cache_dtype)."""
    weight_dtype = args.weight_dtype
    if weight_dtype == "auto":
        weight_dtype = "int8" if args.batch_size <= 32 else "model"
    decode_b = max(args.batch_size // args.n_samples, 1) * args.n_samples
    cache_dtype = args.cache_dtype
    if cache_dtype == "auto":
        cache_dtype = "model" if decode_b <= 1 or meshed else "int8"
    return cache_dtype, weight_dtype, decode_b


def load_params(model_path: str, mcfg: ModelConfig, device="cpu") -> Dict:
    """The model's parameters from ``--model_path`` on ``device``, as stored
    (a train state's f32 masters like a reference checkpoint's weights): a
    trainer's ``save_path`` (the newest ``step_*.pt`` of
    ``train_state_best/``, else of ``train_state/``; ``FileNotFoundError``
    when neither has one), one ``step_*.pt``, or a reference ``.pth`` /
    ``.ckpt`` / ``.pt``. A file's kind is told by its keys, not its suffix.
    A JAX run's Orbax directory is converted first by
    ``scripts/orbax_to_torch.py``."""
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
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.data import MMTGDataset, load_token_embedding_table

    logger = setup_logger()
    mesh, device = mesh_from_args(args, resolve_device(args.device))
    if mcfg is None or dcfg is None:
        if args.variant == "english":
            from mmtg_tpu_torch.configs import english_variant

            tok = load_tokenizer(args.tokenizer_path)
            mcfg, dcfg = english_variant(clip_dim=args.clip_dim,
                                         gpt2_vocab=len(tok))
        else:
            mcfg, dcfg = ModelConfig(), DataConfig()
    cache_dtype, weight_dtype, decode_b = resolve_run_dtypes(
        args, meshed=mesh is not None)
    if mesh is not None and decode_b % mesh.size(0):
        raise ValueError(f"decode batch {decode_b} (batch_size // n_samples * "
                         f"n_samples) must divide over the data axis "
                         f"({mesh.size(0)}); adjust --batch_size")
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
        if mesh is None:
            toks = generate_batch(params, const, mcfg, dcfg, gcfg, batch,
                                  generator).cpu().numpy()
        else:
            # one stream per sample, keyed on its global index
            base = lo * args.n_samples
            seeds = torch.arange(base, base + decode_b, dtype=torch.int32,
                                 device=device)
            toks = generate_sharded(params, const, mcfg, dcfg, gcfg, batch,
                                    prng.PRNGKey(args.seed, device=device), mesh,
                                    row_seeds=seeds).cpu().numpy()
        tokens_generated += toks.shape[0] * gcfg.length
        for r in range(len(rows) * args.n_samples):
            # one sample per line: byte-level BPE can decode to line breaks
            text = postprocess_tokens(toks[r], tokenizer)
            outputs.append(" ".join(text.splitlines()) if text else text)
    dt = time.time() - t0
    logger.info("Generated %d sequences (%.1f tokens/s) in %.1fs",
                len(outputs), tokens_generated / dt, dt)

    if mesh is not None and torch.distributed.get_rank() != 0:
        return  # rank 0 alone writes the samples
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
