"""The plain reference against the port's CPU path at a tiny size, both in
float32: the cached decode's logits under teacher forcing, and a training
step with dropout on (the reference works the masks out from the seeds)."""

import dataclasses

import torch

from h100bench import harness, seeded
from h100bench.reference import model as ref
from h100bench.tests.conftest import TINY_SEED


def test_logits_match_the_cached_decode(tiny):
    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import teacher_forced_decode_logits

    bench, _ = tiny
    cfg = harness.config("tiny", bench)
    m, d = cfg["model"], cfg["data"]
    mcfg, dcfg = harness.model_configs(cfg)
    dev = torch.device("cpu")
    params = seeded.make_weights(m, TINY_SEED, dev, torch.float32)
    table = seeded.make_table(300, 32, TINY_SEED, dev, torch.float32)
    batch = seeded.generate_batch(3, d, m, TINY_SEED, 0, dev, torch.float32)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(104, 300, (3, 60), generator=g)
    toks[:, 0] = ref.START
    toks[1, 40:] = ref.PAD
    gcfg = dataclasses.replace(GenerateConfig(), cache_dtype="model")
    got = teacher_forced_decode_logits(params, {"wenlan_table": table}, mcfg,
                                       dcfg, gcfg, batch, toks,
                                       use_kernels=False)
    want, _ = ref.forward(params, m, d, table, batch, toks, toks != ref.PAD)
    P = d["topic_prompt_length"]
    assert (got - want[:, P:P + 60]).abs().max() < 1e-4


def test_train_step_matches_the_reference(tiny):
    """The cell's own check at a tiny size: the program's first three steps
    in float32 on the CPU against the reference's."""
    bench, man = tiny
    rec = harness.run_cell("zh-train-b256", TINY_SEED, 0.0, False,
                           torch.device("cpu"), 0.0, man, bench=bench)
    r = {k: v["value"] for k, v in rec.checks.items()}
    assert r["loss"] < 1e-6 and r["grad"] < 1e-5 and r["change"] < 1e-3, r
    assert rec.correct
