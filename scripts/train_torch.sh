#!/usr/bin/env bash
# The canonical training flag set (the JAX launcher train.sh) through the PyTorch
# port. Out of the box this trains on the demo fixtures (made below by the
# port's fixture tool) on the CUDA card; add --device cpu to run without
# one. Point the *_data_path / --token_emb_path flags at real pkls for real
# runs, and add
#   --gpt2_ckpt DIR
# to start the decoder from a pretrained GPT-2 (a directory holding
# pytorch_model.bin or model.safetensors; `python -m mmtg_tpu_torch.pretrain`
# writes one).
set -euo pipefail
cd "$(dirname "$0")/.."

[ -f ./data/train_data_with_ratings.pkl ] && [ -f ./vocab/token_id2emb_dict.pkl ] \
    || python -m mmtg_tpu_torch.tools.make_fixtures

python -m mmtg_tpu_torch.train \
    --batch_size 32 \
    --val_batch_size 32 \
    --epochs 5 \
    --lr 1e-05 \
    --curriculums "[1,3]" \
    --seed 42 \
    --log_interval 100 \
    --val_interval_ratio 0.2 \
    --train_data_path ./data/train_data_with_ratings.pkl \
    --val_data_path ./data/val_data_with_ratings.pkl \
    --vocab_path ./vocab/vocab.txt \
    --token_emb_path ./vocab/token_id2emb_dict.pkl \
    --save_path ./models/debug_torch \
    --log_path ./logs/debug_torch.log \
    --alpha 0.2 \
    --save_model \
    "$@"
