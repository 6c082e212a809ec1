"""``python -m mmtg_tpu_torch.train`` on a small model: the CLI's ``main``
with the model and data configs of the torch-saved ``(mcfg, dcfg)`` named by
``$MMTG_TRAIN_CONFIGS`` (the CLI's own default is the 12-layer model), the
dataset's token ids folded into the model's vocabulary and a seeded random
WenLan table of that size (:func:`small_vocab`).
``tests/test_torch_train_mesh_cli.py`` launches it under ``torchrun``."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import data  # noqa: E402
from mmtg_tpu_torch import train  # noqa: E402


def small_vocab(vocab_size: int, setattr_=setattr) -> None:
    """Fold the real vocab's ids into a ``vocab_size``-row model: the
    dataset's ids clamped, the embedding table a seeded random one.
    ``setattr_`` is ``monkeypatch.setattr`` in a test, plain ``setattr`` in
    a job."""
    real = data.MMTGDataset._build

    def build(self, raw, tokenizer, cfg, if_train, seq_len):
        real(self, raw, tokenizer, cfg, if_train, seq_len)
        for k in ("topic_ids", "targets"):
            np.minimum(self._cols[k], vocab_size - 1, out=self._cols[k])

    setattr_(data.MMTGDataset, "_build", build)
    setattr_(data, "load_token_embedding_table",
             lambda path, vocab, emb: np.random.default_rng(1).standard_normal(
                 (vocab_size, emb)).astype(np.float32))


if __name__ == "__main__":
    mcfg, dcfg = torch.load(os.environ["MMTG_TRAIN_CONFIGS"], weights_only=False)
    torch.set_num_threads(1)
    small_vocab(mcfg.gpt2.vocab_size)
    train.main(sys.argv[1:], mcfg=mcfg, dcfg=dcfg)
