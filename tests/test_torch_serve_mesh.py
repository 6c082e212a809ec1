"""The port's meshed serving on the CPU (gloo), at the conftest tiny config:
``GenerationService(mesh=...)`` on rank 0 with ``serve_follower`` on the
other ranks, on the meshes (4, 1) and (2, 2), answers every request — one
shot, streamed, after a weight swap — with the single-device service's
tokens (the drills of tests/test_serve.py:131-161,551-563); the meshed
generate CLI writes the single-device samples of its per-sample streams;
and ``python -m torch.distributed.run --nproc_per_node 2`` of the serve CLI
with ``--mesh_model 2`` answers over HTTP as the single-device CLI does, and
stops cleanly (tests/test_serve.py:705-730).

One ``torchrun`` job of four ranks (``tests/_torch_serve_mesh_job.py``) runs
the service and generate-CLI cases for the module; the serve CLI is a second
launch of two ranks. Each launch has a time limit of its own."""

import json
import os
import pickle
import queue
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from mmtg_tpu.data import MMTGDataset, make_synthetic_records
from mmtg_tpu_torch import decoding, serve
from mmtg_tpu_torch.checkpoint import save_reference_checkpoint
from mmtg_tpu_torch.configs import GenerateConfig, SpecialTokens
from mmtg_tpu_torch.data import MMTGDataset as PortDataset
from mmtg_tpu_torch.generate import load_params, replicate_batch
from mmtg_tpu_torch.ops import prng
from mmtg_tpu_torch.params import init_params
from mmtg_tpu_torch.serve import GenerationService
from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

from _torch_parity import run_torchrun, stop_torchrun, to_port_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((4, 1), (2, 2))
JOB_TIMEOUT_S = 150
START = SpecialTokens().start_id


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    mcfg, dcfg = to_port_config(tiny_model_cfg), to_port_config(tiny_data_cfg)
    rng = np.random.default_rng(13)
    records = make_synthetic_records(4, rng, emb_size=dcfg.wenlan_emb_size)
    ds = MMTGDataset.from_records(records, tokenizer, tiny_data_cfg, if_train=False)
    V = mcfg.gpt2.vocab_size
    samples = []
    for i in range(len(ds)):
        row = {k: np.asarray(v) for k, v in ds[i].items()}
        row["topic_ids"] = np.minimum(row["topic_ids"], V - 1)
        samples.append({k: row[k] for k in serve.SAMPLE_KEYS})
    table = torch.from_numpy(
        rng.standard_normal((V, dcfg.wenlan_emb_size)).astype(np.float32))
    gcfg = GenerateConfig(length=46, top_k=8, top_p=0.7, temperature=1.1,
                          repetition_penalty=1.5, cache_dtype="auto")
    return dict(mcfg=mcfg, dcfg=dcfg, gcfg=gcfg, samples=samples,
                params=init_params(mcfg, seed=3), params_b=init_params(mcfg, seed=99),
                const={"wenlan_table": table})


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory, setup):
    d = tmp_path_factory.mktemp("mesh_cli")
    rng = np.random.default_rng(0)
    records = make_synthetic_records(3, rng, emb_size=setup["dcfg"].wenlan_emb_size)
    for r in records:
        r.pop("rating")
    paths = {"model": str(d / "model.pth"), "data": str(d / "test.pkl"),
             "emb": str(d / "emb.pkl"), "samples": str(d / "samples.txt"),
             "configs": str(d / "configs.pt")}
    save_reference_checkpoint(paths["model"], setup["params"], setup["mcfg"])
    with open(paths["data"], "wb") as f:
        pickle.dump(records, f)
    with open(paths["emb"], "wb") as f:
        pickle.dump({i: rng.standard_normal(setup["dcfg"].wenlan_emb_size)
                     .astype(np.float32) for i in range(0, 13317, 7)}, f)
    torch.save((setup["mcfg"], setup["dcfg"]), paths["configs"])
    return paths


def _generate_argv(paths, vocab):
    return ["--data_path", paths["data"], "--model_path", paths["model"],
            "--tokenizer_path", vocab, "--token_emb_path", paths["emb"],
            "--device", "cpu", "--batch_size", "4", "--n_samples", "2",
            "--seed", "9", "--save_samples", "--save_samples_path",
            paths["samples"], "--mesh_data", "0", "--mesh_model", "2"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


@pytest.fixture(scope="module")
def job(setup, cli_files, reference_vocab_path, tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh_job")
    inputs, out = str(d / "inputs.pt"), str(d / "out.npz")
    torch.save(dict(setup, generate_argv=_generate_argv(cli_files, reference_vocab_path)),
               inputs)
    proc = run_torchrun(4, [os.path.join(REPO, "tests", "_torch_serve_mesh_job.py"),
                            inputs, out], JOB_TIMEOUT_S, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    results = {}
    for rank in range(4):
        with np.load(out if rank == 0 else f"{out}.rank{rank}.npz") as z:
            results[rank] = {k: z[k] for k in z.files}
    return results


def _single_service(setup, params, run):
    svc = GenerationService(params, setup["const"], setup["mcfg"], setup["dcfg"],
                            setup["gcfg"], buckets=(4,), max_wait_ms=1500.0,
                            base_seed=0)
    with svc:
        return run(svc)


@pytest.fixture(scope="module")
def single(setup):
    s = setup["samples"]

    def run(svc):
        futs = [svc.submit(s[i], seed=50 + i) for i in range(3)]
        return (np.stack([f.result(timeout=100) for f in futs]),
                np.concatenate(list(svc.stream(s[0], seed=31))))

    batched, streamed = _single_service(setup, setup["params"], run)
    after = _single_service(setup, setup["params_b"],
                            lambda svc: svc.generate_sync(s[0], seed=50, timeout=100))
    return dict(batched=batched, streamed=streamed, after_swap=after)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_service_matches_single_device(job, single, shape):
    got = job[0][f"{shape[0]}x{shape[1]}/batched"]
    np.testing.assert_array_equal(got, single["batched"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stream_on_mesh_matches_single_device(job, single, shape):
    streamed = job[0][f"{shape[0]}x{shape[1]}/streamed"]
    np.testing.assert_array_equal(np.concatenate([[START], streamed]),
                                  np.concatenate([[START], single["streamed"]]))
    assert streamed.shape == (46,)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_swap_on_mesh_reaches_every_rank(job, single, shape):
    """A swap on rank 0 reaches the followers before the next window: the
    answer is the single-device one on the new weights."""
    name = f"{shape[0]}x{shape[1]}"
    np.testing.assert_array_equal(job[0][f"{name}/after_swap"], single["after_swap"])
    # three windows (one-shot, streamed, after the swap) on every rank
    assert int(job[0][f"{name}/windows"]) == 3
    for rank in (1, 2, 3):
        assert int(job[rank][f"{name}/follower_windows"]) == 3


def test_meshed_service_resolves_fp_cache_and_rejects_indivisible_buckets(job):
    for shape in MESHES:
        assert str(job[0][f"{shape[0]}x{shape[1]}/cache_dtype"]) == "model"
    assert "not divisible by the mesh data axis (4)" in str(job[0]["4x1/indivisible_error"])
    assert str(job[0]["2x2/indivisible_error"]) == ""  # (2, 4) over 2


def test_meshed_generate_cli_writes_the_single_device_samples(job, setup, cli_files,
                                                              reference_vocab_path):
    """The CLI on a (2, 2) mesh: one threefry stream per sample keyed on its
    global index, so the samples are ``generate``'s with those row seeds."""
    from mmtg_tpu_torch.decoding import postprocess_tokens

    mcfg, dcfg = setup["mcfg"], setup["dcfg"]
    tok = WordPieceTokenizer.from_file(reference_vocab_path)
    ds = PortDataset(cli_files["data"], tok, dcfg, if_train=False)
    params = load_params(cli_files["model"], mcfg)
    from mmtg_tpu_torch.data import load_token_embedding_table

    const = {"wenlan_table": torch.from_numpy(load_token_embedding_table(
        cli_files["emb"], len(tok), dcfg.wenlan_emb_size))}
    gcfg = GenerateConfig(batch_size=4, seed=9, n_samples=2, length=dcfg.max_seq_length,
                          cache_dtype="model", weight_dtype="int8")
    want = []
    for lo in (0, 2):
        rows = [ds[i] for i in range(lo, min(lo + 2, len(ds)))]
        batch = replicate_batch(rows + [rows[-1]] * (2 - len(rows)), 2, "cpu")
        toks = decoding.generate(params, const, mcfg, dcfg, gcfg, batch, prng.PRNGKey(9),
                                 row_seeds=torch.arange(2 * lo, 2 * lo + 4,
                                                        dtype=torch.int32)).numpy()
        want += [" ".join(postprocess_tokens(t, tok).splitlines())
                 for t in toks[:2 * len(rows)]]
    with open(cli_files["samples"], encoding="utf-8") as f:
        assert f.read().splitlines() == want
    assert len(want) == 6


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": serve.NPZ_CONTENT_TYPE})
    with urllib.request.urlopen(req, timeout=100) as r:
        return json.loads(r.read())


def test_serve_cli_under_torchrun_answers_as_single_device(setup, cli_files,
                                                           reference_vocab_path):
    cli = ["--model_path", cli_files["model"], "--tokenizer_path", reference_vocab_path,
           "--token_emb_path", cli_files["emb"], "--buckets", "2,4", "--max_wait_ms",
           "0", "--device", "cpu", "--seed", "5", "--no_warmup",
           # the cache a meshed 'auto' resolves to, on both sides
           "--cache_dtype", "model"]
    body = serve.encode_request_npz(setup["samples"][1], seed=7)
    args = serve.build_arg_parser().parse_args(cli)
    svc, _ = serve.build_service(args, setup["mcfg"], setup["dcfg"])
    try:
        want = np.asarray(svc.generate_sync(setup["samples"][1], seed=7, timeout=100))
    finally:
        svc.stop()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.join(REPO, "tests", "_torch_serve_main.py"),
         *cli, "--mesh_model", "2", "--port", "0"],
        cwd=REPO, env=dict(_env(), MMTG_SERVE_CONFIGS=cli_files["configs"]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    log = []
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    try:
        port = pid = None
        while port is None:
            line = lines.get(timeout=JOB_TIMEOUT_S)
            log.append(line)
            m = re.search(r"Serving on http://[\d.]+:(\d+) .*pid (\d+)", line)
            if m:
                port, pid = int(m.group(1)), int(m.group(2))
        assert any("backend gloo" in ln for ln in log), log
        got = _post(port, "/generate", body)
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want)
        os.kill(pid, signal.SIGTERM)  # rank 0 drains and stops its follower
        assert proc.wait(timeout=JOB_TIMEOUT_S) == 0
    finally:
        stop_torchrun(proc)
        reader.join(30)
    while not lines.empty():
        log.append(lines.get())
    assert any("Follower rank 1 stopped after 1 windows" in ln for ln in log), log
