"""The port's quality loop (mmtg_tpu_torch/quality_loop.py) on the CPU: the
curriculum [1,3] through the port's train CLI against the JAX trainer's CLI
on one corpus, each mode's resolved dtypes, and the scaled-down loop (as
tests/test_quality_loop.py runs the JAX tool). The English variant and the
packing A/B: tests/test_torch_quality_loop_variants.py."""

import contextlib
import dataclasses
import logging
import os

import jax
import numpy as np
import pytest
import torch

from mmtg_tpu_torch import quality_loop as ql
from mmtg_tpu_torch import train as ttrain
from mmtg_tpu_torch.checkpoint import newest_step_file
from mmtg_tpu_torch.data import make_synthetic_records

from _torch_parity import no_dropout, to_port_config

torch.set_num_threads(2)


def _jax_tiny_configs():
    """tools/quality_loop.py's model (its run(), variant chinese)."""
    from mmtg_tpu.configs import ChannelConfig, DataConfig, GPT2Config, ModelConfig

    return ModelConfig(
        topic=ChannelConfig(input_dim=64, hidden_dim=32, type="MLP"),
        image=ChannelConfig(input_dim=64, hidden_dim=32),
        text=ChannelConfig(input_dim=64, hidden_dim=32),
        self_att_hidden_size=32, self_att_heads=4, mm_att_out_dim=64,
        gpt2=GPT2Config(vocab_size=13317, n_positions=256, n_ctx=250, n_embd=64,
                        n_layer=2, n_head=4)), DataConfig(wenlan_emb_size=64)


def test_tiny_configs_are_the_jax_tools():
    mcfg, dcfg = _jax_tiny_configs()
    assert ql.tiny_configs() == (to_port_config(mcfg), to_port_config(dcfg))


def _steps(directory):
    """Checkpoint step numbers of an Orbax directory or a port train-state
    directory."""
    out = []
    for name in os.listdir(directory):
        if name.isdigit():
            out.append(int(name))
        elif name.startswith("step_") and name.endswith(".pt"):
            out.append(int(name[len("step_"):-len(".pt")]))
    return sorted(out)


def test_curriculum_cli_matches_jax(tmp_path, monkeypatch):
    """Both trainers' CLIs on one corpus with the JAX tool's flags, f32, no
    dropout, the port's parameters initialized as JAX's: curriculum [1,3]
    over 4 epochs (stage 1 at twice the batch: 2 steps; then 4 a stage-2 and
    stage-3 epoch), the same checkpoint steps in both streams, the val
    curves within 2e-4 at the logged 4 decimals (measured: equal in every
    logged digit, 4.4786 3.4841 3.4419 2.9329) and the final val loss within
    1e-4 relative (measured: 8.1e-8)."""
    from mmtg_tpu import train as jtrain
    from mmtg_tpu.models.mmtg import init_mmtg_params
    from mmtg_tpu_torch import params as tparams

    jm, jd = _jax_tiny_configs()
    jm = no_dropout(jm)
    tm, td = to_port_config(jm), to_port_config(jd)
    rng = np.random.default_rng(0)
    paths = {}
    for name, n in (("train", 32), ("val", 16)):
        paths[name] = ql._write_pickle(str(tmp_path / f"{name}.pkl"),
                                       make_synthetic_records(
                                           n, rng, emb_size=64,
                                           lyrics_pool=ql.LYRICS_POOL))
    emb = ql._write_pickle(str(tmp_path / "emb.pkl"), {
        i: rng.standard_normal(64).astype(np.float32) for i in range(13317)})

    def argv(tag):
        log = str(tmp_path / f"{tag}.log")
        return log, ql.train_flags(paths, ql.VOCAB, emb, 8, 4, log, "float32") + [
            "--save_model", "--save_path", str(tmp_path / tag)]

    jlog, jargv = argv("jax")
    jval = jtrain.main(jargv, mcfg=jm, dcfg=jd)

    def jax_init(mcfg, seed):  # JAX's create_train_state: init on split(key)[0]
        pkey = jax.random.split(jax.random.PRNGKey(seed))[0]
        return tparams.from_jax_numpy(jax.jit(init_mmtg_params, static_argnums=1)(
            pkey, jm))

    monkeypatch.setattr(ttrain, "init_params", jax_init)
    tlog, targv = argv("port")
    tval = ttrain.main(targv + ["--device", "cpu"], mcfg=tm, dcfg=td)

    j, t = ql.parse_log(jlog), ql.parse_log(tlog)
    assert j["steps_per_epoch"] == t["steps_per_epoch"] == [2, 4, 4, 4]
    assert len(j["val_curve"]) == len(t["val_curve"]) == 4
    np.testing.assert_allclose(t["val_curve"], j["val_curve"], rtol=0, atol=2e-4)
    assert float(tval) == pytest.approx(float(jval), rel=1e-4)
    for jsub, tsub in (("orbax", "train_state"), ("orbax_best", "train_state_best")):
        js, ts = _steps(tmp_path / "jax" / jsub), _steps(tmp_path / "port" / tsub)
        assert js == ts and ts, (jsub, js, ts)
    assert _steps(tmp_path / "port" / "train_state") == [2, 6, 10, 14]
    # generate loads the newest best-val step, as the JAX CLI restores it
    picked = newest_step_file(str(tmp_path / "port"))
    assert os.path.dirname(picked) == str(tmp_path / "port" / "train_state_best")
    assert _steps(os.path.dirname(picked))[-1] == _steps(tmp_path / "jax" / "orbax_best")[-1]
    assert os.path.basename(picked) == "step_%08d.pt" % _steps(
        tmp_path / "jax" / "orbax_best")[-1]


EXPECTED_MODES = {"model": ("model", "model", "exact"),
                  "int8": ("int8", "model", "exact"),
                  "int4": ("int4", "model", "exact"),
                  "int8_w8": ("int8", "int8", "exact"),
                  "topk_approx": ("model", "model", "approx")}


@pytest.mark.parametrize("mode", sorted(EXPECTED_MODES))
def test_mode_resolves_to_its_dtypes(mode):
    """Each mode names its dtypes: ``model`` is a full-precision cache with
    full-precision weights."""
    got = ql.mode_dtypes()[mode]
    assert (got["cache_dtype"], got["weight_dtype"], got["topk_impl"]) == \
        EXPECTED_MODES[mode]


def test_jax_tools_model_flags_resolve_to_int8():
    """The JAX tool's ``model`` mode passes no dtype flag: at --batch_size 8
    --n_samples 2 'auto' resolves an int8 cache and int8 weights (as
    mmtg_tpu/generate.py:156-165 does), the fault the port's modes avoid."""
    from mmtg_tpu_torch.generate import build_arg_parser, resolve_run_dtypes

    args = build_arg_parser().parse_args(ql.GEN_FLAGS)
    assert resolve_run_dtypes(args) == ("int8", "int8", 8)


def test_quality_loop_scaled_down(tmp_path):
    """tests/test_quality_loop.py's size: learning across the stage change,
    every mode's lines for each seed, the control; the fp decode is
    reproducible. No threshold on int8 against fp: that is a real fp decode
    here, and the number is reported."""
    report = ql.run(n_train=48, n_val=16, epochs=2, batch_size=8,
                    out_json=str(tmp_path / "quality.json"),
                    work_dir=str(tmp_path / "work"), gen_seeds=(7, 8), device="cpu")
    assert report["learned"], report["val_loss_curve"]
    assert len(report["val_loss_curve"]) == 2
    assert np.isfinite(report["final_val_loss"])
    assert os.path.exists(tmp_path / "quality.json")
    for mode in ql.MODES:
        d2 = report["gen_vs_corpus"][mode]["distinct2"]
        assert 0.0 <= d2["mean"] <= 1.0 and len(d2["per_seed"]) == 2
        for s in (7, 8):
            lines = report["samples"][mode][s]
            assert len(lines) == 8 and all(line.strip() for line in lines)
    assert report["config"]["modes"]["model"]["cache_dtype"] == "model"
    assert report["config"]["modes"]["model"]["weight_dtype"] == "model"
    assert "seed8_vs_seed7" in report["fp_seed_divergence_control"]
    assert report["fp_repeat_identical"]
    # the approximate top-k is the exact one: the fp decode's lines
    assert report["samples"]["topk_approx"] == report["samples"]["model"]
    assert report["cache_mode_vs_fp"]["topk_approx"]["bleu"]["bleu2"] == 1.0
    for m in ("int8", "int4", "int8_w8"):
        assert 0.0 <= report["cache_mode_vs_fp"][m]["bleu"]["bleu2"] <= 1.0


def test_val_line_regex_reads_what_the_trainer_logs(tmp_path):
    log = tmp_path / "train.log"
    log.write_text("x - End eval of epoch 1. Val. Loss: 5.2727\n"
                   "x - Epoch: 1, Step: 3/3, Val. Loss: 5.2727\n"
                   "x - End eval of epoch 2. Val. Loss: nan\n", encoding="utf-8")
    got = ql.parse_log(str(log))
    assert got["val_curve"][0] == 5.2727 and np.isnan(got["val_curve"][1])
    assert got["steps_per_epoch"] == [3]


@pytest.mark.parametrize("entry", ["run", "run_pack_ab", "main"])
def test_quality_loop_without_device_needs_a_gpu(entry, monkeypatch, tmp_path):
    """No silent CPU run: the default device is the CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        if entry == "main":
            ql.main(["--work_dir", str(tmp_path)])
        else:
            getattr(ql, entry)(work_dir=str(tmp_path))


def test_run_rejects_half_a_config(tmp_path):
    mcfg, _ = ql.tiny_configs()
    with pytest.raises(ValueError, match="together"):
        ql.run(work_dir=str(tmp_path), device="cpu", mcfg=dataclasses.replace(mcfg))


def test_a_train_log_holds_each_line_once(tmp_path):
    """setup_logger on a path it already logs to keeps one handler (a line
    is written once), and a run of the loop's train step leaves no handler
    on its log behind it."""
    from mmtg_tpu_torch.utils.logging import setup_logger

    log = str(tmp_path / "train.log")
    setup_logger(log)
    setup_logger(log).info("End eval of epoch 1. Val. Loss: 1.0000")
    with open(log, encoding="utf-8") as f:
        assert sum("End eval" in line for line in f) == 1

    def train_main(argv, mcfg, dcfg):
        setup_logger(log).info("End eval of epoch 1. Val. Loss: 2.0000")
        return 2.0

    final, parsed, _ = ql._train(train_main, [], None, None, log,
                                 lambda label: contextlib.nullcontext(), "train")
    assert final == 2.0 and parsed["val_curve"] == [2.0]
    assert not [h for h in logging.getLogger("mmtg_tpu_torch").handlers
                if getattr(h, "baseFilename", None) == log]
