"""``scripts/orbax_to_torch.py``: a JAX run's Orbax train state, written by
``mmtg_tpu.checkpoint.save_train_state`` after two JAX steps, converted into
the port's ``train_state/step_N.pt``, continues in the port as the JAX run
does (the port's third step equals JAX's, f32, no dropout); the port's train
CLI resumes from the converted save path and its ``generate.load_params``
reads it; a JAX ``pretrain.py`` directory converts to the
``pytorch_model.bin`` that the port's ``--gpt2_ckpt`` loads."""

import dataclasses
import importlib.util
import logging
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import train as jtrain
from mmtg_tpu.checkpoint import save_train_state as jax_save_train_state
from mmtg_tpu.configs import TrainConfig
from mmtg_tpu.models.gpt2 import init_gpt2_params
from mmtg_tpu_torch import generate as tgenerate
from mmtg_tpu_torch import train as ttrain
from mmtg_tpu_torch.checkpoint import restore_train_state
from mmtg_tpu_torch.data import make_synthetic_records
from mmtg_tpu_torch.params import adam_state_to_numpy, init_params, tree_leaves

from _torch_parity import leaf_close, make_train_setup, no_dropout, to_port_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, TOTAL, STAGE = 2, 10, 3


def _converter():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tokenizer, tmp_path_factory):
    """Three JAX steps on one batch; the state after two saved the way the
    JAX trainer saves it (``orbax/`` and ``orbax_best/`` of a save path), then
    converted by the script's CLI."""
    s = make_train_setup(tokenizer, n=4, ratings=[5.0, 1.0, 4.0, 3.0])
    s["mcfg"] = no_dropout(s["mcfg"])
    s["tmcfg"] = to_port_config(s["mcfg"])
    jt = TrainConfig(alpha=0.2, dtype="float32", lr=1e-4, remat=False, attn_impl="xla")
    state, tx = jtrain.create_train_state(jax.random.PRNGKey(0), s["mcfg"], jt,
                                          WARMUP, TOTAL, params=s["jparams"])
    step = jtrain.make_train_step(s["mcfg"], s["dcfg"], jt, tx)
    states, metrics = [], []
    for _ in range(3):
        state, m = step(jax.tree.map(jnp.array, state), s["jconst"], s["jbatch"],
                        jnp.asarray(STAGE))
        states.append(state)
        metrics.append(m)
    save = str(tmp_path_factory.mktemp("orbax_run"))
    for sub, st in (("orbax", states[1]), ("orbax_best", states[0])):
        jax_save_train_state(os.path.join(save, sub), int(st.step), jax.device_get(st))
    assert _converter().main(["--save_path", save], mcfg=s["mcfg"]) == 0
    tt = dataclasses.replace(to_port_config(jt), attn_impl="kernel")
    return dict(s, jt=jt, tt=tt, states=states, metrics=metrics, save=save)


def test_converter_writes_each_stream_at_its_step(run):
    assert os.listdir(os.path.join(run["save"], "train_state")) == ["step_00000002.pt"]
    assert os.listdir(os.path.join(run["save"], "train_state_best")) == [
        "step_00000001.pt"]


def test_converted_state_continues_the_jax_run(run):
    """The port's step on the converted state = JAX's third step: loss,
    parameters, AdamW moments and count (the tolerances of the Adam-state
    bridge's test in tests/test_torch_train_step.py)."""
    tt = run["tt"]
    fresh, tx = ttrain.create_train_state(0, run["tmcfg"], tt, WARMUP, TOTAL,
                                          device="cpu")
    state, step = restore_train_state(os.path.join(run["save"], "train_state"), fresh)
    assert step == 2 and state.step == 2 and int(state.opt_state["count"]) == 2
    jax_params = jax.tree.leaves(run["states"][1].params)
    for got, ref in zip(tree_leaves(state.params), jax_params):
        assert np.array_equal(got.detach().numpy(), np.asarray(ref))
    state, m = ttrain.make_train_step(run["tmcfg"], run["tdcfg"], tt, tx)(
        state, run["tconst"], run["tbatch"], STAGE)
    ref_m, ref = run["metrics"][2], run["states"][2]
    for k in ("loss", "kl", "total", "kept"):
        assert float(m[k]) == pytest.approx(float(ref_m[k]), abs=1e-5), k
    for got, want in zip(tree_leaves(state.params), jax.tree.leaves(ref.params)):
        assert float(np.abs(got.detach().numpy() - np.asarray(want)).max()) <= 1e-6
    mu, nu, count = adam_state_to_numpy(state.opt_state)
    adam = ref.opt_state[1][0]
    assert count == int(adam.count) == 3
    for got, want in zip(jax.tree.leaves(mu) + jax.tree.leaves(nu),
                         jax.tree.leaves(adam.mu) + jax.tree.leaves(adam.nu)):
        leaf_close(got, want, 1e-5)


def test_converted_generator_is_seeded_from_the_seed_flag(run):
    raw = torch.load(os.path.join(run["save"], "train_state", "step_00000002.pt"),
                     weights_only=True)
    assert torch.equal(raw["rng_state"], torch.Generator().manual_seed(43).get_state())


def test_generate_load_params_reads_the_converted_save_path(run):
    """The best-val stream first, as for a save path the port's trainer wrote."""
    got = tgenerate.load_params(run["save"], run["tmcfg"])
    for g, r in zip(tree_leaves(got), jax.tree.leaves(run["states"][0].params)):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_train_cli_resumes_from_the_converted_save_path(run, reference_vocab_path,
                                                        tmp_path, monkeypatch, caplog):
    """8 rows at batch 4: two steps an epoch, so step 2 resumes at epoch 2
    and the run ends at step 4."""
    from mmtg_tpu_torch import data

    save = str(tmp_path / "run")  # a copy: the other tests read the original
    shutil.copytree(run["save"], save)
    rng = np.random.default_rng(0)
    dcfg = run["tdcfg"]
    paths = {}
    for name, n in (("train", 8), ("val", 4)):
        paths[name] = str(tmp_path / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(make_synthetic_records(n, rng, emb_size=dcfg.wenlan_emb_size), f)
    V = run["tmcfg"].gpt2.vocab_size
    real = data.MMTGDataset._build

    def build(self, raw, tokenizer, cfg, if_train, seq_len):
        real(self, raw, tokenizer, cfg, if_train, seq_len)
        for k in ("topic_ids", "targets"):
            np.minimum(self._cols[k], V - 1, out=self._cols[k])

    monkeypatch.setattr(data.MMTGDataset, "_build", build)
    monkeypatch.setattr(data, "load_token_embedding_table",
                        lambda path, vocab, emb: rng.standard_normal((V, emb)).astype(
                            np.float32))
    argv = ["--train_data_path", paths["train"], "--val_data_path", paths["val"],
            "--vocab_path", reference_vocab_path, "--token_emb_path", "unused.pkl",
            "--batch_size", "4", "--val_batch_size", "4", "--curriculums", "0,0",
            "--alpha", "0.2", "--epochs", "2", "--dtype", "float32", "--save_model",
            "--save_path", save, "--resume", "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="mmtg_tpu_torch"):
        val = ttrain.main(argv, mcfg=run["tmcfg"], dcfg=dcfg)
    assert np.isfinite(val)
    assert any("Resumed from step 2 (epoch 1)" in r.getMessage() for r in caplog.records)
    assert sorted(os.listdir(os.path.join(save, "train_state"))) == [
        "step_00000002.pt", "step_00000004.pt"]


def test_pretrain_directory_converts_to_what_gpt2_ckpt_loads(run, tmp_path):
    """A JAX pretrain.py save path (an Orbax ``{"gpt2": params}``) → the
    ``pytorch_model.bin`` the port's pretrain writes; --gpt2_ckpt loads the
    same numbers."""
    g = run["mcfg"].gpt2
    gpt2 = init_gpt2_params(jax.random.PRNGKey(5), g)
    src = str(tmp_path / "phase1")
    jax_save_train_state(src, 7, {"gpt2": jax.device_get(gpt2)})
    assert _converter().main(["--pretrain", src], mcfg=run["mcfg"]) == 0
    assert os.path.exists(os.path.join(src, "pytorch_model.bin"))
    params = init_params(run["tmcfg"], seed=1)
    ttrain.load_gpt2_ckpt_into(params, src, run["tmcfg"])
    got, want = tree_leaves(params["gpt2"]), jax.tree.leaves(gpt2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_missing_orbax_directory_raises(tmp_path, run):
    with pytest.raises(SystemExit, match="no orbax"):
        _converter().main(["--save_path", str(tmp_path)], mcfg=run["mcfg"])
