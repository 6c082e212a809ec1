#!/usr/bin/env bash
# The canonical generation flag set (the JAX launcher generate.sh) through the
# PyTorch port. Out of the box this decodes the demo fixtures with the
# ./models/debug_torch run that train_torch.sh writes, on the CUDA card; add
# --device cpu to run without one. Extra arguments go to the generate CLI,
# and to train_torch.sh when it trains first: give there only flags both
# CLIs take (--device, --seed, --batch_size). Point
# --data_path / --model_path at a real test pkl and save path (or a
# reference .pth).
set -euo pipefail
cd "$(dirname "$0")/.."

[ -f ./data/final_test.pkl ] && [ -f ./vocab/token_id2emb_dict.pkl ] \
    || python -m mmtg_tpu_torch.tools.make_fixtures
# no checkpoint yet? train one on the demo fixtures
[ -d ./models/debug_torch ] || bash scripts/train_torch.sh "$@"

python -m mmtg_tpu_torch.generate \
    --batch_size 32 \
    --seed 42 \
    --data_path ./data/final_test.pkl \
    --model_path ./models/debug_torch \
    --tokenizer_path ./vocab/vocab.txt \
    --token_emb_path ./vocab/token_id2emb_dict.pkl \
    --temperature 1.1 \
    --topk 10 \
    --topp 0.7 \
    --repetition_penalty 1.5 \
    --n_samples 10 \
    --save_samples \
    --save_samples_path res/test_torch.txt \
    "$@"
