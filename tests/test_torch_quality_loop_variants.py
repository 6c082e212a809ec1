"""The port's quality loop on the CPU at a scaled-down size, the two other
entry points of tools/quality_loop.py: ``--variant english`` (a byte-level
BPE vocab trained on the pool, english_variant() dims) and ``--pack_ab``
(parity rows against --pack_sequences --pack_row_len 256)."""

import os

import numpy as np
import torch

from mmtg_tpu_torch import quality_loop as ql

torch.set_num_threads(2)


def test_quality_loop_english_scaled_down(tmp_path):
    report = ql.run(n_train=48, n_val=16, epochs=2, batch_size=8,
                    work_dir=str(tmp_path / "work"), gen_seeds=(7, 8),
                    variant="english", device="cpu")
    assert report["config"]["variant"] == "english"
    assert os.path.isdir(tmp_path / "work" / "bpe_vocab")
    assert os.path.exists(tmp_path / "work" / "quality_loop.json")
    assert report["learned"], report["val_loss_curve"]
    assert len(report["val_loss_curve"]) == 2
    for mode in ql.MODES:
        for s in (7, 8):
            lines = report["samples"][mode][s]
            assert len(lines) == 8 and all(line.strip() for line in lines)
        assert 0.0 <= report["gen_vs_corpus"][mode]["distinct2"]["mean"] <= 1.0
    assert report["fp_repeat_identical"]
    assert report["samples"]["topk_approx"] == report["samples"]["model"]


def test_pack_ab_scaled_down(tmp_path):
    """Both runs train on one corpus and are measured by the unpacked val
    loss; rows of 256 hold every sample (the packer drops none)."""
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.data import MMTGDataset
    from mmtg_tpu_torch.pack import PackedBatcher

    work = tmp_path / "pack"
    report = ql.run_pack_ab(n_train=48, n_val=16, epochs=2, batch_size=8,
                            work_dir=str(work), device="cpu")
    assert os.path.exists(work / "pack_ab.json")
    for tag in ("parity", "packed"):
        curve = report[tag]["val_curve"]
        assert len(curve) == 2 and np.all(np.isfinite(curve)), (tag, curve)
        assert np.isfinite(report[tag]["final_val"])
    assert report["parity"]["steps_per_epoch"] == [6, 6]  # 48 rows / batch 8
    assert report["both_learned"], report
    _, dcfg = ql.tiny_configs()
    data = MMTGDataset(str(work / "train.pkl"), load_tokenizer(ql.VOCAB), dcfg,
                       if_train=True)
    packer = PackedBatcher(data.arrays(), dcfg, row_len=256, max_slots=8)
    slots = sum(int(b["slot_valid"].sum())
                for b in packer.batches(8, shuffle=True, rng=np.random.default_rng(0)))
    assert slots == 48
