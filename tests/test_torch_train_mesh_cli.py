"""The port's train CLI on a mesh on the CPU (gloo), launched by ``torchrun``
through ``tests/_torch_train_main.py`` (the CLI's ``main`` with a tiny model:
2 layers, 12 heads of 8, vocab 50, no dropout): one epoch on ``--mesh_data 2
--zero1`` writes the FULL train state from rank 0 alone, equal to the
single-process run's; single-device ``generate.load_params`` reads it;
``--resume`` continues it on ``--mesh_model 2``. ``--multihost`` joins a job of
two simulated nodes of two ranks each on localhost and trains as the single
process does; the same job without the flag raises."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmtg_tpu_torch import train as cli
from mmtg_tpu_torch.generate import load_params
from mmtg_tpu_torch.params import tree_leaves

from _torch_parity import mesh_model_cfg, no_dropout, run_torchrun, stop_torchrun, \
    to_port_config, train_configs
from _torch_train_main import small_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = os.path.join(REPO, "tests", "_torch_train_main.py")
JOB_TIMEOUT_S = 150
TOL = 1e-5  # f32: the ranks' sums run in another order


@pytest.fixture(scope="module")
def cfgs():
    return (to_port_config(no_dropout(mesh_model_cfg())),
            to_port_config(train_configs()[1]))


@pytest.fixture(scope="module")
def files(tmp_path_factory, cfgs):
    from mmtg_tpu_torch.data import make_synthetic_records

    d = tmp_path_factory.mktemp("train_mesh_cli")
    rng = np.random.default_rng(0)
    paths = {}
    for name, n in (("train", 8), ("val", 4)):
        paths[name] = str(d / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(make_synthetic_records(n, rng,
                                               emb_size=cfgs[1].wenlan_emb_size), f)
    paths["emb"] = str(d / "emb.pkl")
    with open(paths["emb"], "wb") as f:
        pickle.dump({0: np.zeros(cfgs[1].wenlan_emb_size, np.float32)}, f)
    paths["configs"] = str(d / "configs.pt")
    torch.save(cfgs, paths["configs"])
    return d, paths


def _args(files, vocab, save, *extra):
    _, p = files
    return ["--train_data_path", p["train"], "--val_data_path", p["val"],
            "--vocab_path", vocab, "--token_emb_path", p["emb"],
            "--batch_size", "4", "--val_batch_size", "4", "--lr", "1e-3",
            "--curriculums", "0,0", "--alpha", "0.2", "--log_interval", "1",
            "--dtype", "float32", "--save_model", "--save_path", save,
            "--device", "cpu", *extra]


def _env(files):
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                MMTG_TRAIN_CONFIGS=files[1]["configs"])


def _state(save, step):
    return torch.load(os.path.join(save, "train_state", f"step_{step:08d}.pt"),
                      weights_only=True)


def _close(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= TOL


@pytest.fixture(scope="module")
def single(files, reference_vocab_path, cfgs):
    """The single-process run: one epoch, then a second one resumed."""
    mp = pytest.MonkeyPatch()
    small_vocab(cfgs[0].gpt2.vocab_size, mp.setattr)
    try:
        save = str(files[0] / "single")
        cli.main(_args(files, reference_vocab_path, save, "--epochs", "1"),
                 mcfg=cfgs[0], dcfg=cfgs[1])
        cli.main(_args(files, reference_vocab_path, save, "--epochs", "2",
                       "--resume"), mcfg=cfgs[0], dcfg=cfgs[1])
    finally:
        mp.undo()
    return save


@pytest.fixture(scope="module")
def zero1_run(files, reference_vocab_path):
    save = str(files[0] / "zero1")
    proc = run_torchrun(2, [MAIN, *_args(files, reference_vocab_path, save,
                                         "--epochs", "1", "--mesh_data", "2",
                                         "--zero1")],
                        JOB_TIMEOUT_S, cwd=REPO, env=_env(files))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return save, proc.stdout + proc.stderr


def test_zero1_epoch_writes_the_full_state_from_rank_0(zero1_run, single):
    save, log = zero1_run
    assert sorted(os.listdir(os.path.join(save, "train_state"))) == ["step_00000002.pt"]
    assert os.listdir(os.path.join(save, "train_state_best"))
    assert log.count("Total training steps") == 1  # only rank 0 logs
    assert "Mesh ('data', 'model') (2, 1) of 2 ranks (gloo)" in log
    got, want = _state(save, 2), _state(single, 2)
    assert got["step"] == want["step"] == 2
    for k in ("params", "opt_state"):
        _close(got[k], want[k])


def test_generate_loads_the_mesh_save_path_single_device(zero1_run, cfgs):
    params = load_params(zero1_run[0], cfgs[0])
    assert params["gpt2"]["h"]["attn_w"].shape == (2, 96, 288)
    _close(params, _state(zero1_run[0], 2)["params"])


def test_resume_on_a_tensor_parallel_mesh(zero1_run, files, reference_vocab_path,
                                          single):
    save = zero1_run[0]
    proc = run_torchrun(2, [MAIN, *_args(files, reference_vocab_path, save,
                                         "--epochs", "2", "--resume",
                                         "--mesh_model", "2")],
                        JOB_TIMEOUT_S, cwd=REPO, env=_env(files))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    log = proc.stdout + proc.stderr
    assert "Resumed from step 2 (epoch 1)" in log
    assert "Mesh ('data', 'model') (1, 2) of 2 ranks (gloo)" in log
    assert sorted(os.listdir(os.path.join(save, "train_state"))) == [
        "step_00000002.pt", "step_00000004.pt"]
    got, want = _state(save, 4), _state(single, 4)
    for k in ("params", "opt_state"):
        _close(got[k], want[k])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_nodes(files, vocab, save, per_node, *extra):
    """Two ``torchrun`` launchers on localhost, one a simulated node, each of
    ``per_node`` ranks, joined by a static rendezvous. Returns (exit codes,
    output)."""
    port = _free_port()
    procs = []
    for node in range(2):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
               "--node_rank", str(node), "--nproc_per_node", str(per_node),
               "--master_addr", "127.0.0.1", "--master_port", str(port), MAIN,
               *_args(files, vocab, save, "--epochs", "1", *extra)]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=_env(files), text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOB_TIMEOUT_S)[0])
    finally:
        for p in procs:
            stop_torchrun(p)
    return [p.returncode for p in procs], "".join(outs)


def test_multihost_two_nodes_train_as_the_single_process(files, reference_vocab_path,
                                                         single):
    save = str(files[0] / "multihost")
    rcs, log = _two_nodes(files, reference_vocab_path, save, 2, "--multihost",
                          "--mesh_data", "0")
    assert rcs == [0, 0], log[-6000:]
    assert "Mesh ('data', 'model') (4, 1) of 4 ranks (gloo)" in log
    got, want = _state(save, 2), _state(single, 2)
    for k in ("params", "opt_state"):
        _close(got[k], want[k])


def test_a_job_across_nodes_without_multihost_raises(files, reference_vocab_path):
    rcs, log = _two_nodes(files, reference_vocab_path, str(files[0] / "nomh"), 1)
    assert rcs != [0, 0]
    assert "the job spans nodes (1 of its 2 ranks on this one): pass --multihost" in log
