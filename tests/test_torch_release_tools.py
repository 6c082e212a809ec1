"""The port's release tools (mmtg_tpu_torch/tools/bench_pack.py,
multihost_smoke.py, release_check.py, make_fixtures.py) against the JAX
package's tools/ and scripts/ of the same names, on the CPU.

What is held: bench_pack's JSON keys (and its native fields where a C++
compiler exists), the multihost smoke under 2 gloo ranks (its loss with
dropout off equal to JAX's single-device train step on the same parameters
and batch; with ``--dryrun`` the TP, pipeline, eval and sharded-decode runs,
whose losses then equal it too), release_check's runner (a timed-out step's
whole process group killed, later steps skipped; the card's steps failing,
not skipped, without a card), and make_fixtures' records and table equal to
the JAX script's."""

import ast
import dataclasses
import importlib.util
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch.tools import bench_pack, make_fixtures, multihost_smoke, release_check

from _torch_parity import to_port_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys_in_call(rel, attr):
    """The string keys of the dict literal passed to ``<x>.<attr>(...)`` in
    the JAX file ``rel``."""
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == attr
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no {attr}({{...}}) in {rel}")


# -- bench_pack ---------------------------------------------------------------


def test_bench_pack_prints_the_jax_tools_keys(capsys):
    line = bench_pack.run(64)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert list(line) == _dict_keys_in_call("tools/bench_pack.py", "dumps")
    assert line["n_samples"] == 64 and line["python_s"] > 0
    native = ("hybrid_native_tok_s", "hybrid_samples_s", "native_s",
              "native_samples_s", "speedup")
    if shutil.which("g++"):
        assert all(line[k] is not None for k in native), line
    else:
        assert all(line[k] is None for k in native), line


# -- multihost_smoke ----------------------------------------------------------


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_multihost_smoke_two_gloo_ranks_equals_the_jax_step(tmp_path):
    """Dropout off, JAX's PRNGKey(0) init handed to every rank: the global
    step's loss equals JAX's single-device make_train_step on the same
    batch, on the data mesh and on the dryrun's TP and pipeline meshes."""
    from mmtg_tpu.configs import ChannelConfig, DataConfig, GPT2Config, ModelConfig
    from mmtg_tpu.configs import TrainConfig
    from mmtg_tpu.models.mmtg import init_mmtg_params
    from mmtg_tpu.train import create_train_state, make_train_step

    import __graft_entry__ as g

    jm = ModelConfig(
        topic=ChannelConfig(input_dim=64, hidden_dim=32, type="MLP"),
        image=ChannelConfig(input_dim=64, hidden_dim=32),
        text=ChannelConfig(input_dim=64, hidden_dim=32),
        self_att_hidden_size=32, self_att_heads=4, mm_att_out_dim=64,
        gpt2=GPT2Config(vocab_size=256, n_positions=256, n_embd=64, n_layer=2,
                        n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))
    jd, jt = DataConfig(wenlan_emb_size=64), TrainConfig(lr=1e-3, alpha=0.2)
    pm, pd, pt = multihost_smoke.tiny_configs()
    assert dataclasses.replace(pm, gpt2=dataclasses.replace(
        pm.gpt2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)) == to_port_config(jm)
    assert (pd, pt) == (to_port_config(jd), to_port_config(jt))

    world = 2
    B = multihost_smoke.ROWS_PER_RANK * world
    batch, const = multihost_smoke.inputs(world, pm, pd)
    rng = np.random.default_rng(0)
    jbatch = {k: np.asarray(v) for k, v in g._make_batch(
        B, jd, jm.gpt2.vocab_size, rng).items()}
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k], v, err_msg=k)
    np.testing.assert_array_equal(
        const["wenlan_table"],
        rng.standard_normal((jm.gpt2.vocab_size, jd.wenlan_emb_size)).astype(np.float32))

    # the JAX tool's create_train_state(PRNGKey(0)) init, its draws jitted
    # (op by op, each of the init's small random draws compiles)
    pkey = jax.random.split(jax.random.PRNGKey(0))[0]
    state, tx = create_train_state(
        jax.random.PRNGKey(0), jm, jt, warmup_steps=2, total_steps=10,
        params=jax.jit(init_mmtg_params, static_argnums=1)(pkey, jm))
    path = tmp_path / "params.pt"
    torch.save(tparams.from_jax_numpy(jax.tree.map(np.asarray, state.params)), path)
    step = make_train_step(jm, jd, jt, tx)
    _, m = step(state, {"wenlan_table": const["wenlan_table"]}, batch, np.int32(2))
    want = float(m["total"])

    out = tmp_path / "losses.json"
    env = dict(_env(), MMTG_SMOKE_PARAMS=str(path), MMTG_SMOKE_OUT=str(out))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(world), os.path.join(REPO, "tests", "_torch_multihost_main.py"),
         "--device", "cpu", "--dryrun"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for pid in range(world):
        assert re.search(rf"multihost smoke OK pid={pid}/{world}: global devices="
                         rf"{world} \(gloo, cpu\) loss=[0-9.]+ step=1", proc.stdout)
    assert "dryrun OK: 2 ranks" in proc.stdout
    # the data mesh's step, then the dryrun's TP and pipeline steps: with
    # dropout off each sees the JAX step's loss
    losses = json.loads(out.read_text())
    assert len(losses) == 3
    assert all(abs(x - want) <= 1e-5 for x in losses), (losses, want)
    evals = re.findall(r"eval loss=([0-9.]+)", proc.stdout)
    assert len(evals) == world and all(abs(float(x) - want) <= 1e-4 for x in evals)
    assert proc.stdout.count("generate_sharded") == world * 2


def test_multihost_smoke_without_a_launcher_raises():
    """--multihost needs the launcher's environment, as the train CLI's."""
    env = {k: v for k, v in _env().items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    proc = subprocess.run(
        [sys.executable, "-m", "mmtg_tpu_torch.tools.multihost_smoke", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--multihost joins a job a launcher started" in proc.stderr


# -- release_check --------------------------------------------------------------


def _state(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return None


def test_release_check_kills_a_timed_out_group_and_skips_the_rest(tmp_path):
    pidfile = tmp_path / "grandchild.pid"
    slow = (f"import subprocess, sys, time\n"
            f"p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
            f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
            f"time.sleep(120)\n")
    py = sys.executable
    t0 = time.monotonic()
    results = release_check.run_steps([
        ("first", [py, "-c", "pass"], 60.0),
        ("slow", [py, "-c", slow], 3.0),
        ("after", [py, "-c", "pass"], 60.0),
        ("card", None, 60.0),
    ])
    assert time.monotonic() - t0 < 30
    assert [r["step"] for r in results] == ["first", "slow", "after", "card"]
    assert results[0]["ok"] and not results[0]["timed_out"]
    assert not results[1]["ok"] and results[1]["timed_out"]
    assert all(r.get("skipped_after_timeout") and not r["ok"] for r in results[2:])
    grandchild = int(pidfile.read_text())
    deadline = time.monotonic() + 10
    while _state(grandchild) not in (None, "Z") and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _state(grandchild) in (None, "Z"), "the step's grandchild outlived it"


def test_release_check_fails_the_card_steps_without_a_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = release_check.build_arg_parser().parse_args(["--tests", "fast"])
    sel = release_check.steps(args)
    assert [s[0] for s in sel] == ["native", "tests", "dryrun", "validate", "bench"]
    assert sel[1][1][-len(release_check.FAST_TESTS) - 1:-1] == release_check.FAST_TESTS
    assert all(os.path.exists(os.path.join(REPO, t)) for t in release_check.FAST_TESTS)
    assert [s[1] for s in sel[3:]] == [None, None]
    no_gpu = release_check.steps(release_check.build_arg_parser().parse_args(
        ["--no-gpu", "--tests", "none"]))
    assert [s[0] for s in no_gpu] == ["native", "dryrun"]
    # the whole gate with every host step passing: FAIL, the card's steps
    # reported failed (not skipped)
    monkeypatch.setattr(release_check, "_run", lambda name, cmd, timeout: {
        "step": name, "ok": True, "seconds": 0.0, "timed_out": False})
    assert release_check.main(["--tests", "none"]) == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["release_check"] == "FAIL"
    assert [(s["step"], s["ok"]) for s in summary["steps"]] == [
        ("native", True), ("dryrun", True), ("validate", False), ("bench", False)]
    assert all(s.get("no_gpu") for s in summary["steps"][2:])
    assert release_check.main(["--tests", "none", "--no-gpu"]) == 0
    assert set(json.loads(capsys.readouterr().out.strip().splitlines()[-1])) == set(
        _dict_keys_in_call("tools/release_check.py", "dumps"))


def test_release_check_native_step_builds_both_libraries():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    r = release_check._run("native", [sys.executable, "-c", release_check.NATIVE], 600.0)
    assert r["ok"], r


# -- make_fixtures ------------------------------------------------------------


def _jax_fixtures(root, argv):
    mod = _load("scripts/make_fixtures.py", "jax_scripts_make_fixtures")
    old = sys.argv
    sys.argv = ["make_fixtures.py", "--root", str(root), *argv]
    try:
        mod.main()
    finally:
        sys.argv = old


def _read(root, rel):
    with open(os.path.join(root, rel), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("argv", [["--skip-emb-table"],
                                  ["--vocab_size", "50", "--emb_size", "8",
                                   "--seed", "3"]])
def test_make_fixtures_equals_the_jax_script(tmp_path, argv, capsys):
    _jax_fixtures(tmp_path / "jax", argv)
    assert make_fixtures.main(["--root", str(tmp_path / "port"), *argv]) == 0
    jax_out = capsys.readouterr().out
    files = ["data/train_data_with_ratings.pkl", "data/val_data_with_ratings.pkl",
             "data/final_test.pkl"]
    for rel in files:
        want, got = _read(tmp_path / "jax", rel), _read(tmp_path / "port", rel)
        assert len(got) == len(want) > 0
        for w, gg in zip(want, got):
            assert set(gg) == set(w)
            for k, v in w.items():
                np.testing.assert_array_equal(np.asarray(gg[k]), np.asarray(v))
    table = "vocab/token_id2emb_dict.pkl"
    if "--skip-emb-table" in argv:
        assert not (tmp_path / "port" / table).exists()
    else:
        want, got = _read(tmp_path / "jax", table), _read(tmp_path / "port", table)
        assert list(got) == list(want) == list(range(50))
        for i in want:
            np.testing.assert_array_equal(got[i], want[i])
            assert got[i].dtype == np.float32 and got[i].shape == (8,)
    assert "final_test.pkl (4 records)" in jax_out
