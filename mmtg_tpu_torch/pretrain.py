"""Phase-1 GPT-2 lyrics pretraining (:mod:`mmtg_tpu.pretrain`).

A standard causal LM trainer over a lyrics text corpus (one sentence per
line, framed ``[#START#] … [#EOS#]`` and packed into fixed-length rows),
producing the GPT-2 checkpoint that phase 2 starts from: ``--save_path`` is
a directory that receives ``pytorch_model.bin`` (an HF ``GPT2LMHeadModel``
state dict), which ``python -m mmtg_tpu_torch.train --gpt2_ckpt <save_path>``
loads. The stack attends through the hand-written ``mha_train_packed``
kernels for CUDA tensors (:mod:`mmtg_tpu_torch.ops.train_attention`).

    python -m mmtg_tpu_torch.pretrain --corpus lyrics.txt \\
        --vocab_path vocab/vocab.txt --save_path pretrained/phase1 --epochs 1
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from mmtg_tpu_torch.configs import GPT2Config, SpecialTokens, TrainConfig
from mmtg_tpu_torch.models.gpt2 import export_hf_gpt2, gpt2_forward
from mmtg_tpu_torch.params import init_gpt2_params, tree_leaves, tree_map
from mmtg_tpu_torch.train import AdamW, make_schedule
from mmtg_tpu_torch.utils.logging import StepTimer, setup_logger

SPECIAL = SpecialTokens()


def pack_corpus(lines: List[str], tokenizer, seq_len: int = 128) -> np.ndarray:
    """Frame each line ``[#START#] tokens [#EOS#]`` and pack greedily into
    ``[N, seq_len]`` rows (PAD-filled tails)."""
    start_id = tokenizer.convert_tokens_to_ids("[#START#]")
    eos_id = tokenizer.convert_tokens_to_ids("[#EOS#]")
    rows, cur = [], []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        ids = [start_id] + tokenizer.encode(line) + [eos_id]
        if cur and len(cur) + len(ids) > seq_len:
            rows.append(cur + [SPECIAL.pad_id] * (seq_len - len(cur)))
            cur = []
        if len(ids) > seq_len:
            ids = ids[:seq_len]
        cur += ids
    if cur:
        rows.append(cur + [SPECIAL.pad_id] * (seq_len - len(cur)))
    return np.asarray(rows, np.int32)


def lm_loss(params, cfg: GPT2Config, batch_ids: torch.Tensor,
            dropout_gen: Optional[torch.Generator] = None,
            attn_impl: str = "auto") -> torch.Tensor:
    """Shifted CE with PAD positions masked out (as keys and as targets)."""
    T = batch_ids.shape[1]
    mask = (batch_ids != SPECIAL.pad_id).to(torch.int32)
    logits, _ = gpt2_forward(
        params, cfg, params["wte"][batch_ids],
        torch.arange(T, device=batch_ids.device)[None, :],
        attention_mask=mask, dropout_gen=dropout_gen,
        deterministic=dropout_gen is None, attn_impl=attn_impl)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, batch_ids[:, 1:, None].long())[..., 0]
    w = mask[:, 1:].float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def main(argv=None, cfg: Optional[GPT2Config] = None) -> None:
    """CLI entry; ``cfg`` is injectable so tests can drive the loop with a
    tiny model on the CPU (its ``vocab_size`` must cover the tokenizer)."""
    p = argparse.ArgumentParser(description="MMTG phase-1 GPT-2 pretraining")
    p.add_argument("--corpus", required=True, type=str,
                   help="text file, one lyric sentence per line")
    p.add_argument("--vocab_path", required=True, type=str)
    p.add_argument("--save_path", required=True, type=str)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--seq_len", default=128, type=int)
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--lr", default=5e-5, type=float)
    p.add_argument("--warmup_ratio", default=0.1, type=float)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--log_interval", default=50, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda; pass 'cpu' to run "
                        "without a GPU)")
    args = p.parse_args(argv)

    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.generate import resolve_device

    device = resolve_device(args.device)
    logger = setup_logger()
    tokenizer = load_tokenizer(args.vocab_path)
    with open(args.corpus, encoding="utf-8") as f:
        rows = pack_corpus(f.readlines(), tokenizer, args.seq_len)
    logger.info("Packed corpus: %d rows of %d tokens", len(rows), args.seq_len)

    if cfg is None:
        cfg = GPT2Config(vocab_size=len(tokenizer))
    params = tree_map(lambda x: x.requires_grad_(True),
                      init_gpt2_params(cfg, seed=args.seed, device=device))

    steps_per_epoch = math.ceil(len(rows) / args.batch_size)
    total = steps_per_epoch * args.epochs
    warmup = max(int(total * args.warmup_ratio), 1)
    # warmup, then a decay over the REMAINING total - warmup steps so the
    # rate hits 0 exactly at the end (train.make_schedule); AdamW with the
    # JAX trainer's eps and optax.adamw's default weight decay
    tx = AdamW(make_schedule(TrainConfig(lr=args.lr), warmup, total),
               b1=0.9, b2=0.999, eps=1e-6, weight_decay=1e-4, clip_norm=1.0)
    opt_state = tx.init(params)
    leaves = tree_leaves(params)
    keep = torch.ones((), dtype=torch.bool, device=device)
    dropout_gen = torch.Generator().manual_seed(args.seed + 1)

    rng_np = np.random.default_rng(args.seed)
    timer = StepTimer(device=device)
    gstep, loss = 0, float("nan")
    for epoch in range(args.epochs):
        order = rng_np.permutation(len(rows))
        t1 = time.time()
        for lo in range(0, len(rows), args.batch_size):
            idx = order[lo:lo + args.batch_size]
            if len(idx) < args.batch_size:  # one shape per step: pad w/ row 0
                idx = np.concatenate([idx, np.zeros(args.batch_size - len(idx), int)])
            batch = torch.from_numpy(rows[idx]).to(device)
            timer.start()
            step_loss = lm_loss(params, cfg, batch, dropout_gen)
            tx.update_(leaves, torch.autograd.grad(step_loss, leaves),
                       opt_state, keep)
            loss = float(step_loss.detach())  # waits for the device
            timer.stop()
            gstep += 1
            if gstep % args.log_interval == 0:
                logger.info("epoch %d step %d loss %.4f (%.1f rows/s)",
                            epoch + 1, gstep, loss,
                            timer.throughput(args.batch_size))
        logger.info("epoch %d done in %.1fs, last loss %.4f",
                    epoch + 1, time.time() - t1, loss)

    os.makedirs(args.save_path, exist_ok=True)
    out = os.path.join(args.save_path, "pytorch_model.bin")
    torch.save(export_hf_gpt2(params, cfg), out)
    logger.info("Saved phase-1 GPT-2 checkpoint to %s (step %d)", out, gstep)


if __name__ == "__main__":
    main()
