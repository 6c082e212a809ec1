"""The port's trace tools (mmtg_tpu_torch/tools/trace_train.py,
trace_decode.py) against the JAX package's tools/trace_train.py, on the CPU
at a tiny size.

What is held: the trace parser (the same self times, counts, busy total and
wall as JAX's on the same events, written in each package's trace layout),
the category table summing to the busy total, the synthetic train batch
(equal to the JAX tool's array for array), the ``--json`` keys, that a
``trace_decode`` run and a train CLI ``--profile_dir`` trace parse with
``--parse-only``, and that both tools refuse to run without a card unless
given ``--device cpu``."""

import ast
import dataclasses
import gzip
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch

from mmtg_tpu_torch.tools import trace_decode, trace_train

from _torch_parity import to_port_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/trace_train.py, loaded by path, with its
    module-level compilation-cache set-up made a no-op."""
    from mmtg_tpu.utils import platform

    real = platform.enable_compilation_cache
    platform.enable_compilation_cache = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tools_trace_train", os.path.join(REPO, "tools", "trace_train.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        platform.enable_compilation_cache = real
    return mod


@pytest.fixture(scope="module")
def cfgs(tiny_model_cfg, tiny_data_cfg):
    """(JAX mcfg, JAX dcfg, port mcfg, port dcfg): the conftest tiny model
    with its vocab widened to 8192 (the synthetic batch draws topic ids up
    to 7999)."""
    jm = dataclasses.replace(tiny_model_cfg, gpt2=dataclasses.replace(
        tiny_model_cfg.gpt2, vocab_size=8192))
    return jm, tiny_data_cfg, to_port_config(jm), to_port_config(tiny_data_cfg)


# -- the parser against JAX's ----------------------------------------------------


def _nested_events(rng):
    """Device events over two threads: nested spans (a parent with children
    and a grandchild, a child ending exactly where the next starts) and a
    run of flat random ones; the names repeat so per-op sums matter."""
    evs = [  # (tid, name, ts, dur)
        (1, "fusion.1", 0.0, 100.0), (1, "dot.2", 10.0, 20.0),
        (1, "copy.3", 30.0, 30.0), (1, "add.4", 35.5, 4.25),
        (1, "dot.2", 60.0, 40.0), (1, "fusion.1", 150.0, 10.0),
        (2, "reduce.5", 5.0, 50.0), (2, "gather.6", 5.0, 12.0),
        (2, "exp.7", 17.0, 3.0),
    ]
    t = 200.0
    for _ in range(40):
        t += float(rng.uniform(0.0, 5.0))
        d = float(rng.uniform(0.5, 9.0))
        evs.append((int(rng.integers(1, 3)), f"op.{int(rng.integers(8, 14))}", t, d))
        t += d
    return evs


def _write_jax_layout(root, evs):
    """A jax.profiler dump: plugins/profile/<run>/<host>.trace.json.gz with
    a /device:TPU:0 process, its op threads, and a host process."""
    d = root / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    meta = [
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 1, "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 2, "args": {"name": "XLA Ops #2"}},
        {"ph": "M", "name": "process_name", "pid": 9, "args": {"name": "/host:CPU"}},
    ]
    xs = [{"ph": "X", "pid": 7, "tid": tid, "name": n, "ts": ts, "dur": dur}
          for tid, n, ts, dur in evs]
    host = [{"ph": "X", "pid": 9, "tid": 1, "name": "host_op", "ts": 0.0, "dur": 999.0}]
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": meta + xs + host}, f)


def _write_port_layout(root, evs):
    """A torch.profiler (Kineto) trace: trace_<pid>_<ns>.json with the GPU
    timeline (pid 0, one tid a stream, ``kernel`` / ``gpu_memcpy`` events)
    beside the CPU operators and runtime calls, which must be left out."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 1, "args": {"name": "stream 7 "}},
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python"}},
    ]
    xs = [{"ph": "X", "cat": "gpu_memcpy" if n == "copy.3" else "kernel", "pid": 0,
           "tid": tid, "name": n, "ts": ts, "dur": dur, "args": {"stream": tid}}
          for tid, n, ts, dur in evs]
    cpu = [{"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 4242, "name": "aten::mm",
            "ts": 0.0, "dur": 500.0},
           {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 4242,
            "name": "cudaLaunchKernel", "ts": 1.0, "dur": 2.0},
           {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 1,
            "name": "step", "ts": 0.0, "dur": 400.0},
           {"ph": "X", "cat": "Trace", "pid": "Spans", "tid": 0,
            "name": "PyTorch Profiler (0)", "ts": 0.0, "dur": 600.0}]
    with open(root / "trace_4242_1.json", "w") as f:
        json.dump({"traceEvents": meta + cpu + xs}, f)


def test_parse_trace_equals_the_jax_tools(tmp_path, jax_tool):
    evs = _nested_events(np.random.default_rng(0))
    _write_jax_layout(tmp_path / "jax", evs)
    (tmp_path / "port").mkdir()
    _write_port_layout(tmp_path / "port", evs)
    want = jax_tool.parse_trace(str(tmp_path / "jax"), 3)
    got = trace_train.parse_trace(str(tmp_path / "port"), 3)
    assert got["on_gpu"] and got["device_pids"] == {0}
    assert got["pname"][0] == "GPU 0"
    assert set(got["per_op"]) == set(want["per_op"])
    for name, us in want["per_op"].items():
        assert got["per_op"][name] == pytest.approx(us, abs=1e-9), name
    assert got["per_op_count"] == want["per_op_count"]
    assert got["total_us"] == pytest.approx(want["total_us"], abs=1e-9)
    assert got["wall_us"] == pytest.approx(want["wall_us"], abs=1e-9)
    # the nested spans' self times, by hand: fusion.1 100 - 20 - 30 - 40 + 10
    assert got["per_op"]["fusion.1"] == pytest.approx(20.0)
    assert got["per_op"]["copy.3"] == pytest.approx(30.0 - 4.25)
    assert sum(got["cats"].values()) == pytest.approx(got["total_us"])


def test_category_rows_keep_the_jax_order_and_name_the_port_kernels(jax_tool):
    labels = [label for label, _ in trace_train.CATEGORIES]
    assert labels[3:] == [label for label, _ in jax_tool.CATEGORIES[1:]]
    assert "pallas" in jax_tool.CATEGORIES[0][0]
    cases = {
        "void mha_fwd_tc_kernel<64, true>(__nv_bfloat16 const*, int)": labels[0],
        "void mha_bwd_dq_tc_kernel<64, false>(__nv_bfloat16 const*)": labels[0],
        "void mha_bwd_dkdv_kernel<float, 64>(float const*)": labels[0],
        "void decode_attention_kernel<__nv_bfloat16, 1>(void*)": labels[0],
        "void decode_attention_int4_kernel<__nv_bfloat16>(void*)": labels[0],
        "void decode_block_fused_kernel<__nv_bfloat16>(Args<__nv_bfloat16>)": labels[1],
        "void fused_gru_kernel<__nv_bfloat16>(float const*, float*)": labels[2],
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT": labels[3],
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": labels[3],
        "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>(Params)": labels[3],
        "void at::native::(anonymous namespace)::distribution_elementwise_grid_"
        "stride_kernel<float, 4>(long, PhiloxCudaState)": labels[4],
        "void at::native::indexing_backward_kernel<float, 4>(long const*)": labels[6],
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
        "at::native::MeanOps<float, float, float, float>>>(Op)": labels[7],
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_"
        "nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>>": labels[8],
        "Memcpy HtoD (Pageable -> Device)": labels[8],
        "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_"
        "add<float>, std::array<char*, 3ul>>(int, CUDAFunctor_add<float>)": labels[9],
        "aten::addmm": labels[3], "aten::mean": labels[7], "aten::copy_": labels[8],
        "aten::tanh": labels[9], "aten::embedding": labels[6],
    }
    for name, label in cases.items():
        assert trace_train.category(name) == label, name
    assert trace_train.category("something_else") == "other"


def test_newest_trace_is_read(tmp_path):
    (tmp_path / "a").mkdir()
    old, new = tmp_path / "trace_1_1.json", tmp_path / "a" / "trace_2_2.json.gz"
    old.write_text("{}")
    new.write_bytes(gzip.compress(b"{}"))
    os.utime(old, (1, 1))
    assert trace_train.newest_trace(str(tmp_path)) == str(new)
    with pytest.raises(SystemExit, match="no trace"):
        trace_train.newest_trace(str(tmp_path / "a" / "none"))


# -- the step's inputs ----------------------------------------------------------


def test_build_step_batch_equals_the_jax_tools(cfgs, jax_tool, monkeypatch):
    """The JAX tool's build_step with its model set-up stubbed (the batch
    and table are drawn before it): the arrays it feeds equal the port's."""
    import mmtg_tpu.configs as jconfigs
    import mmtg_tpu.models.mmtg as jmmtg
    import mmtg_tpu.train as jtrain

    jm, jd, pm, pd = cfgs
    monkeypatch.setattr(jconfigs, "ModelConfig", lambda: jm)
    monkeypatch.setattr(jconfigs, "DataConfig", lambda: jd)
    monkeypatch.setattr(jmmtg, "init_mmtg_params", lambda *a, **k: None)
    monkeypatch.setattr(jtrain, "create_train_state", lambda *a, **k: (None, None))
    monkeypatch.setattr(jtrain, "make_train_step", lambda *a, **k: None)
    _, _, jconst, jbatch, stage = jax_tool.build_step(6, "float32", "auto")
    batch, const = trace_train.synthetic_batch(6, pm, pd, np.random.default_rng(0))
    assert int(stage) == 3
    assert set(batch) == set(jbatch)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k], np.asarray(v), err_msg=k)
        assert batch[k].dtype == np.asarray(v).dtype, k
    np.testing.assert_array_equal(const["wenlan_table"],
                                  np.asarray(jconst["wenlan_table"]))


def _jax_json_keys():
    """The keys of the object the JAX tool's ``--json`` writes."""
    with open(os.path.join(REPO, "tools", "trace_train.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dump"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dump of a dict in tools/trace_train.py")


def _check_sums(s):
    assert sum(s["categories_ms"].values()) == pytest.approx(s["ms_per_step_busy"],
                                                             rel=1e-9)
    assert 0 < s["ms_per_step_busy"]


# -- the tools on the CPU -------------------------------------------------------


def test_trace_train_on_the_cpu(tmp_path, cfgs, capsys):
    _, _, pm, pd = cfgs
    out, js = tmp_path / "trace", tmp_path / "t.json"
    args = trace_train.build_arg_parser().parse_args(
        ["--device", "cpu", "--batch", "2", "--steps", "2", "--out", str(out),
         "--json", str(js), "--top", "5", "--dtype", "float32"])
    r = trace_train.run(args, pm, pd)
    printed = capsys.readouterr().out
    assert "traced 2 steps," in printed and "== categories" in printed
    s = json.loads(js.read_text())
    assert set(s) == _jax_json_keys() == {"ms_per_step_busy", "ms_per_step_wall",
                                          "steps", "categories_ms", "top_ops_ms"}
    assert s["steps"] == 2 and len(s["top_ops_ms"]) == 5
    _check_sums(s)
    assert s["ms_per_step_busy"] <= s["ms_per_step_wall"] * 1.0001
    assert not r["parse"]["on_gpu"] and r["parse"]["per_op_count"]["aten::mm"] > 0
    assert "dense matmul (qkv/mlp/proj/lmhead)" in s["categories_ms"]
    # the same directory again, parse only: the same numbers
    again = trace_train.run(trace_train.build_arg_parser().parse_args(
        ["--parse-only", "--out", str(out), "--steps", "2", "--top", "5"]))
    assert again["summary"] == s and again["wall_ms_per_step"] is None


def test_trace_decode_parses_with_parse_only(tmp_path, cfgs, capsys):
    _, _, pm, pd = cfgs
    pd = dataclasses.replace(pd, max_seq_length=22)  # one sentence frame
    out = tmp_path / "decode"
    r = trace_decode.run(trace_decode.build_arg_parser().parse_args(
        ["--device", "cpu", "--batch", "3", "--out", str(out)]), pm, pd)
    assert "traced b3 model/int8/auto ->" in capsys.readouterr().out
    assert tuple(r["tokens"].shape) == (3, 23) and r["gcfg"].length == 22
    assert (r["gcfg"].cache_dtype, r["gcfg"].weight_dtype) == ("int8", "model")
    p = trace_train.run(trace_train.build_arg_parser().parse_args(
        ["--parse-only", "--steps", "22", "--out", str(out)]))
    _check_sums(p["summary"])
    assert p["summary"]["steps"] == 22


def test_parse_only_reads_a_train_cli_profile_dir(tmp_path, cfgs, monkeypatch,
                                                   reference_vocab_path):
    """The train CLI's --profile_dir (steps 10 and 11 of a 12-step epoch)."""
    from mmtg_tpu_torch import data
    from mmtg_tpu_torch import train as cli
    from mmtg_tpu_torch.data import make_synthetic_records

    _, _, pm, pd = cfgs
    # the real vocab's ids, all of them
    pm = dataclasses.replace(pm, gpt2=dataclasses.replace(pm.gpt2, vocab_size=13317))
    rng = np.random.default_rng(0)
    for name, n in (("train", 12), ("val", 2)):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(make_synthetic_records(n, rng, emb_size=pd.wenlan_emb_size), f)
    monkeypatch.setattr(
        data, "load_token_embedding_table",
        lambda path, vocab, emb: np.random.default_rng(1).standard_normal(
            (pm.gpt2.vocab_size, emb)).astype(np.float32))
    prof = tmp_path / "prof"
    cli.main(["--train_data_path", str(tmp_path / "train.pkl"),
              "--val_data_path", str(tmp_path / "val.pkl"),
              "--vocab_path", reference_vocab_path, "--token_emb_path", "unused",
              "--batch_size", "1", "--val_batch_size", "2", "--epochs", "1",
              "--curriculums", "0,0", "--alpha", "0.2", "--log_interval", "100",
              "--val_interval_ratio", "1.0", "--dtype", "float32",
              "--device", "cpu", "--profile_dir", str(prof)], mcfg=pm, dcfg=pd)
    assert len(os.listdir(prof)) == 1
    p = trace_train.run(trace_train.build_arg_parser().parse_args(
        ["--parse-only", "--steps", "2", "--out", str(prof)]))
    _check_sums(p["summary"])
    assert p["parse"]["per_op_count"]["aten::mm"] > 0


@pytest.mark.parametrize("tool", ["trace_train", "trace_decode"])
def test_without_a_card_the_tools_raise(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = {"trace_train": trace_train, "trace_decode": trace_decode}[tool]
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.run(mod.build_arg_parser().parse_args(["--out", str(tmp_path)]))
