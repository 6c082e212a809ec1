"""The port's serving and latency tools (mmtg_tpu_torch/tools/) against the
JAX package's tools/ of the same names, on the CPU at the conftest tiny
config (vocab widened to 8192, since the tools' payloads draw topic ids up
to 7999, and 44-token lyrics).

What is held: the traffic (payloads and WenLan table array for array), the
service's tokens for that traffic (equal to the JAX service's in f32), each
tool's flags and defaults and the keys of every JSON line it prints, the
soak's shedding and drain, the fixed-cost fit, and the latency floor's
refusals (null on the CPU, ValueError for an unknown card). Every test runs
under its own time limit and leaves no service thread behind."""

import ast
import dataclasses
import importlib.util
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch.serve import GenerationService
from mmtg_tpu_torch.tools import (bench_latency, bench_serve, bench_serve_http,
                                  bench_stream, fixed_cost_sweep, serve_common,
                                  soak_serve)

from _torch_parity import to_port_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"serve_common": serve_common, "bench_serve": bench_serve,
         "bench_stream": bench_stream, "soak_serve": soak_serve,
         "bench_serve_http": bench_serve_http,
         "fixed_cost_sweep": fixed_cost_sweep, "bench_latency": bench_latency}
RUNNABLE = [n for n in TOOLS if n != "serve_common"]


@pytest.fixture(autouse=True)
def limit():
    """Each test's own time limit: 60 s, then it fails instead of hanging."""
    def on_alarm(signum, frame):
        raise TimeoutError("test exceeded its 60 s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def no_thread_left_behind():
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.name.startswith("mmtg-") and t.is_alive()]
    assert not left, f"service threads still alive: {left}"


def _jax_tool(name):
    """The JAX package's tools/<name>.py, loaded by path (its module level
    imports numpy and the standard library only)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cfgs(tiny_model_cfg, tiny_data_cfg):
    """(JAX mcfg, JAX dcfg, port mcfg, port dcfg)."""
    jm = dataclasses.replace(tiny_model_cfg, gpt2=dataclasses.replace(
        tiny_model_cfg.gpt2, vocab_size=8192))
    jd = dataclasses.replace(tiny_data_cfg, max_seq_length=44)
    return jm, jd, to_port_config(jm), to_port_config(jd)


@pytest.fixture(scope="module")
def weights(cfgs):
    """The tools' bf16 model at the tiny config, built once."""
    return serve_common.build_model("int8", "cpu", cfgs[2], cfgs[3])[:2]


# ---- the traffic ----------------------------------------------------------


@pytest.mark.parametrize("i", range(8))
def test_make_payload_equals_jax_helper(cfgs, i):
    jm, jd, pm, pd = cfgs
    want = _jax_tool("serve_common").make_payload(i, jd, jm)
    got = serve_common.make_payload(i, pd, pm)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_build_model_table_is_the_jax_draw(cfgs):
    jm, jd, pm, pd = cfgs
    draw = np.random.default_rng(0).standard_normal(
        (jm.gpt2.vocab_size, jd.wenlan_emb_size))
    params, const, mcfg, dcfg, gcfg = serve_common.build_model(
        "int8", "cpu", pm, pd, dtype=torch.float32)
    np.testing.assert_array_equal(const["wenlan_table"].numpy(),
                                  draw.astype(np.float32))
    # bf16, as the tools run: the same rounding of the float64 draw as JAX's
    bf16 = serve_common.build_model("int8", "cpu", pm, pd)[1]["wenlan_table"]
    np.testing.assert_array_equal(
        bf16.float().numpy(),
        np.asarray(jnp.asarray(draw, jnp.bfloat16).astype(jnp.float32)))
    assert (gcfg.cache_dtype, gcfg.length) == ("int8", 44)
    # at the full-size data config the length is the JAX GenerateConfig's
    from mmtg_tpu.configs import GenerateConfig as JaxGenerateConfig
    from mmtg_tpu_torch.configs import DataConfig

    assert DataConfig().max_seq_length == JaxGenerateConfig().length
    with pytest.raises(ValueError, match="together"):
        serve_common.build_model("int8", "cpu", pm, None)


def test_service_tokens_equal_jax_service_in_f32(cfgs):
    """The tools' traffic (4 payloads, 4 seeds) through the port's service
    and the JAX service on the same f32 weights (JAX's init_mmtg_params)
    and table: the same tokens (threefry per-request streams)."""
    from mmtg_tpu.configs import GenerateConfig as JaxGenerateConfig
    from mmtg_tpu.models.mmtg import init_mmtg_params
    from mmtg_tpu.serve import GenerationService as JaxService

    jm, jd, pm, pd = cfgs
    jparams = jax.jit(init_mmtg_params, static_argnums=1)(jax.random.PRNGKey(0), jm)
    table = serve_common.make_table(pm, pd, np.random.default_rng(0)).astype(np.float32)
    payloads = [serve_common.make_payload(i, pd, pm) for i in range(4)]
    seeds = [5, -6, 7, 2 ** 31 + 3]
    jsvc = JaxService(jparams, {"wenlan_table": jnp.asarray(table)}, jm, jd,
                      JaxGenerateConfig(cache_dtype="int8", length=44),
                      buckets=(4,), max_wait_ms=200.0).start()
    try:
        futs = [jsvc.submit(p, seed=s) for p, s in zip(payloads, seeds)]
        want = [np.asarray(f.result(timeout=50)) for f in futs]
    finally:
        jsvc.stop()
    params, const, mcfg, dcfg, gcfg = serve_common.build_model(
        "int8", "cpu", pm, pd, weights=(tparams.from_jax_numpy(jparams),
                                         {"wenlan_table": torch.from_numpy(table)}))
    svc = GenerationService(params, const, mcfg, dcfg, gcfg, buckets=(4,),
                            max_wait_ms=200.0).start()
    try:
        futs = [svc.submit(p, seed=s) for p, s in zip(payloads, seeds)]
        got = [f.result(timeout=30) for f in futs]
    finally:
        svc.stop()
    assert (svc.gcfg.weight_dtype, svc.gcfg.cache_dtype) == ("int8", "int8")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- flags and JSON keys ----------------------------------------------------


def _jax_flags(name):
    """{flag: default} of the JAX tool's parser, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "tools", f"{name}.py")).read())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            default = next((ast.literal_eval(k.value) for k in node.keywords
                            if k.arg == "default"), None)
            flags[node.args[0].value] = default
    return flags


# the port's additions and the JAX flags it drops (XLA-only), by tool
ADDED = {"bench_serve": {"--device", "--attn-impl"},
         "bench_stream": {"--device", "--attn-impl"},
         "soak_serve": {"--device", "--attn-impl"},
         "bench_serve_http": {"--device", "--attn-impl"},
         "fixed_cost_sweep": {"--device"}, "bench_latency": {"--device"}}
DROPPED = {"bench_latency": {"--layer-unroll"}}
# F is the port's own (a sweep on the card), never the TPU's 39.6 ms
OWN_DEFAULTS = {("bench_latency", "--fixed-cost-ms"): None}


@pytest.mark.parametrize("name", RUNNABLE)
def test_flags_and_defaults_are_the_jax_tools(name):
    jax_flags = _jax_flags(name)
    ap = TOOLS[name].build_arg_parser()
    port = {a.option_strings[0]: a.default for a in ap._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert set(port) == (set(jax_flags) - DROPPED.get(name, set())) | ADDED[name]
    for flag, default in jax_flags.items():
        if flag in port:
            assert port[flag] == OWN_DEFAULTS.get((name, flag), default), flag
    assert port["--device"] is None
    if "--attn-impl" in port:
        attn = next(a for a in ap._actions if "--attn-impl" in a.option_strings)
        assert attn.choices == ["auto", "kernel", "fused"] and attn.default == "auto"


def test_help_carries_no_tpu_figure():
    """No TPU-measured rate or fixed cost is stated as the port's."""
    for name in RUNNABLE:
        text = TOOLS[name].build_arg_parser().format_help() + TOOLS[name].__doc__
        for figure in ("410", "230/s", "39.6"):
            assert figure not in text, (name, figure)


# the keys of each JSON line the JAX tools print, written out from their
# sources; a dict stands for a nested object, a one-element list for a list
# of such objects
GCFG = {"weight_dtype": None, "cache_dtype": None, "length": None}
SAT = {"metric": None, "value": None, "unit": None, "detail": dict.fromkeys([
    "requests", "clients", "wall_s", "requests_per_s", "p50_latency_s",
    "p95_latency_s", "mean_batch", "batches", "mean_fill", "buckets",
    "max_wait_ms", "cache_dtype"])}
SOLO = {"metric": None, "value": None, "unit": None,
        "detail": dict.fromkeys(["runs", "best_s", "bucket"])}
STREAM = {"metric": None, "value": None, "unit": None, "vs_baseline": None,
          "detail": dict(dict.fromkeys([
              "streams", "chunk_tokens", "blocks_per_stream", "ttfs_ms_p50",
              "ttfs_ms_best", "inter_block_ms_p50", "stream_total_ms_p50",
              "oneshot_ms_p50", "stream_overhead_ms_p50",
              "tokens_identical_to_batched"]), gcfg=GCFG)}
CONCURRENT = {"metric": None, "value": None, "unit": None, "vs_baseline": None,
              "detail": dict(dict.fromkeys([
                  "concurrent", "ttfs_ms_p50", "stream_total_ms_p50",
                  "mean_batch", "windows", "buckets"]), gcfg=GCFG, rounds=[
                      dict.fromkeys(["tok_s", "wall_s", "ttfs_ms_p50",
                                     "total_ms_p50"])])}
SNAPSHOT = dict.fromkeys([
    "t_s", "submitted", "done", "failed", "rejected", "backlog", "mean_batch",
    "tokens_per_s", "interval_tokens_per_s", "interval_p50_s", "interval_p99_s"])
SUMMARY = dict.fromkeys([
    "metric", "ok", "duration_s", "requested_duration_s", "rate_req_s",
    "submitted", "done", "failed", "rejected", "lost", "max_backlog",
    "service_errors", "tokens_served", "tokens_per_s", "p50_s", "p95_s",
    "p99_s", "mean_batch"])
HTTP = {"metric": None, "value": None, "unit": None, "detail": dict.fromkeys([
    "requests_ok", "errors", "first_error", "wall_s", "requests_per_s",
    "p50_latency_s", "p95_latency_s", "payload_bytes",
    "client_encode_ms_per_req", "buckets", "max_wait_ms", "cache_dtype"])}
SWEEP = dict.fromkeys([
    "fixed_ms", "per_step_ms_at_0", "per_step_ms_at_L", "quad_ms_per_step2",
    "wall_ms_at_L", "fixed_share_pct", "tok_s_at_L", "tok_s_if_fixed_free"])
LATENCY = {"metric": None, "value": None, "unit": None, "vs_baseline": None,
           "detail": dict(dict.fromkeys([
               "cache_dtype", "length", "fixed_cost_ms", "hbm_peak_gbps",
               "floor_model", "device"]), rows=[dict.fromkeys([
                   "batch", "cache_dtype", "weight_dtype", "attn_impl",
                   "layer_unroll", "p50_ms", "best_ms", "ms_per_token_per_row",
                   "tok_s", "memory_floor_ms", "x_of_floor"])])}

# (tool, argv, the JSON lines it prints in order; "snapshot..." = any number)
RUNS = {
    "bench_serve": ("bench_serve", "--clients 4 --requests 6 --buckets 2,4 "
                    "--solo-runs 2 --attn-impl kernel", [SAT, SOLO]),
    "bench_stream": ("bench_stream", "--streams 2", [STREAM]),
    "bench_stream_concurrent": ("bench_stream", "--concurrent 3 --buckets 4 "
                                "--rounds 1", [CONCURRENT]),
    "soak_serve": ("soak_serve", "--rate 20 --duration_s 1 --snapshot_every_s 0.5 "
                   "--buckets 2,4", [SNAPSHOT, SNAPSHOT, SUMMARY]),
    "bench_serve_http": ("bench_serve_http", "--clients 3 --requests 4 "
                         "--buckets 4", [HTTP, HTTP]),
    "bench_serve_http_two_buckets": ("bench_serve_http", "--clients 2 --requests 2 "
                                     "--buckets 1,2 --encodings npz", [HTTP]),
    "fixed_cost_sweep": ("fixed_cost_sweep", "--batch 2 --lengths 22,33,44,55 "
                         "--runs 1", [SWEEP]),
    "bench_latency": ("bench_latency", "--batches 1,2 --runs 1 --length 22",
                      [LATENCY]),
}


def _keys(obj, like):
    """``obj``'s key structure against ``like``'s (see above)."""
    if isinstance(like, dict):
        assert isinstance(obj, dict) and set(obj) == set(like), (
            sorted(set(obj) ^ set(like)))
        for k, v in like.items():
            if v is not None:
                _keys(obj[k], v)
    elif isinstance(like, list):
        assert isinstance(obj, list) and obj
        for o in obj:
            _keys(o, like[0])


@pytest.mark.parametrize("case", list(RUNS))
def test_run_on_the_cpu_prints_the_jax_keys(case, cfgs, weights, capsys):
    name, argv, expected = RUNS[case]
    mod = TOOLS[name]
    out = mod.run(mod.build_arg_parser().parse_args(argv.split() + ["--device", "cpu"]),
                  cfgs[2], cfgs[3], weights=weights)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == out["lines"] and len(printed) == len(expected)
    for line, like in zip(printed, expected):
        _keys(line, like)
    if "service" in out:  # the service's resolved settings, per scenario
        for facts in out["service"].values():
            assert facts["device"] == "cpu" and facts["windows"] > 0
            assert facts["attn_impl"] in ("kernel", "fused")
    if name == "bench_latency":  # no floor on the CPU
        d = printed[0]["detail"]
        assert d["fixed_cost_ms"] is None and d["hbm_peak_gbps"] is None
        assert d["device"] == "cpu"
        for row in d["rows"]:
            assert row["memory_floor_ms"] is None and row["x_of_floor"] is None
        assert [(r["batch"], r["cache_dtype"]) for r in d["rows"]] == [
            (1, "model"), (1, "model"), (2, "int8"), (2, "int8")]
    if name == "bench_serve_http":  # each response against submit()'s, any menu
        assert out["tokens_checked"] is True
    if name == "bench_stream" and "concurrent" not in argv:
        assert printed[0]["detail"]["tokens_identical_to_batched"] is True


@pytest.mark.parametrize("name", RUNNABLE)
def test_run_needs_a_card_unless_asked_for_the_cpu(name, cfgs):
    mod = TOOLS[name]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.run(mod.build_arg_parser().parse_args([]), cfgs[2], cfgs[3])


# ---- the soak ------------------------------------------------------------------


def _soak(cfgs, weights, argv):
    return soak_serve.run(soak_serve.build_arg_parser().parse_args(
        argv.split() + ["--device", "cpu"]), cfgs[2], cfgs[3], weights=weights)


def test_soak_under_capacity_is_ok_without_rejection(cfgs, weights):
    out = _soak(cfgs, weights, "--rate 8 --duration_s 1 --snapshot_every_s 0.5 "
                "--buckets 2,4")
    s = out["lines"][-1]
    assert s["ok"] and s["rejected"] == 0 and s["lost"] == 0 and s["done"] > 0
    assert s["submitted"] == s["done"] and s["service_errors"] == 0


def test_soak_overload_sheds_and_loses_nothing(cfgs, weights):
    """max_queue_depth 2 against far more arrivals than a window of 4 rows
    a decode can take: rejections counted (not failures), nothing lost, the
    backlog never past the queue, the window forming and two formed windows
    not yet collected (plus one for two producers' race at the depth
    check)."""
    out = _soak(cfgs, weights, "--rate 300 --producers 2 --duration_s 1 "
                "--snapshot_every_s 0.5 --buckets 2,4 --max_queue_depth 2")
    s = out["lines"][-1]
    assert s["ok"] and s["rejected"] > 0 and s["lost"] == 0 and s["failed"] == 0
    assert s["max_backlog"] <= 2 + (2 - 1) + 3 * 4
    assert all(ln["backlog"] <= s["max_backlog"] for ln in out["lines"][:-1])
    assert out["service"]["soak"]["windows"] * 4 >= s["done"]


# ---- the fixed-cost fit and the latency floor -------------------------------------


def _jax_fit(results, batch):
    """tools/fixed_cost_sweep.py's fit and line, as its source has them."""
    Ls = np.array(sorted(results))
    ys = np.array([results[L] for L in Ls])
    A = np.stack([np.ones_like(Ls), Ls, Ls**2 / 2], axis=1).astype(float)
    coef, *_ = np.linalg.lstsq(A, ys, rcond=None)
    F, a, b = coef
    L = max(Ls)
    return {
        "fixed_ms": round(F * 1e3, 1),
        "per_step_ms_at_0": round(a * 1e3, 3),
        "per_step_ms_at_L": round((a + b * L) * 1e3, 3),
        "quad_ms_per_step2": round(b * 1e6, 4),
        "wall_ms_at_L": round(float(ys[-1]) * 1e3, 1),
        "fixed_share_pct": round(100 * F / float(ys[-1]), 1),
        "tok_s_at_L": round(batch * int(L) / float(ys[-1]), 1),
        "tok_s_if_fixed_free": round(batch * int(L) / float(ys[-1] - F), 1),
    }


@pytest.mark.parametrize("F,a,b", [(0.040, 0.0086, 0.0), (0.120, 0.004, 2e-6),
                                   (0.0, 0.01, 1e-5)])
def test_fixed_cost_fit_recovers_its_terms(F, a, b):
    walls = {L: F + a * L + b * L * L / 2 for L in (60, 120, 180, 220)}
    got = fixed_cost_sweep.fit(walls, 64)
    assert got == _jax_fit(walls, 64)
    assert got["fixed_ms"] == round(F * 1e3, 1)
    assert got["per_step_ms_at_0"] == round(a * 1e3, 3)
    assert got["quad_ms_per_step2"] == round(b * 1e6, 4)


def test_latency_floor_refusals():
    assert bench_latency.memory_floor_ms(1e9, None, 5.0) is None  # the CPU
    with pytest.raises(ValueError, match="no published HBM peak"):
        bench_latency.memory_floor_ms(1e9, "NVIDIA A100-SXM4-80GB", 5.0)
    # 3.35 TB/s on the H100 SXM: 3.35 GB in 1 ms, plus F; a negative fit of F
    # (the sweep's noise) counts as 0
    assert bench_latency.memory_floor_ms(3.35e9, "NVIDIA H100 80GB HBM3", 5.0) == 6.0
    assert bench_latency.memory_floor_ms(3.35e9, "NVIDIA H100 80GB HBM3", -7.0) == 1.0


# ---- warm-ups: once a shape in a process ----------------------------------


class _StubService:
    """What serve_common.warm_service reads of a service, its warm-ups kept."""

    def __init__(self, params, mcfg, buckets):
        from mmtg_tpu_torch.configs import GenerateConfig

        self.params, self.mcfg, self.buckets = params, mcfg, buckets
        self.device = torch.device("cpu")
        self.gcfg = GenerateConfig(cache_dtype="int8", length=44)
        self.warmed = []

    def warmup(self, bucket=None, streams=True):
        assert streams is False
        self.warmed.append(bucket)


def test_a_shape_is_warmed_once_a_process(cfgs):
    _, _, pm, _ = cfgs
    weights = {"w": torch.zeros(1)}
    first = _StubService(weights, pm, (8, 16))
    serve_common.warm_service(first)
    assert first.warmed == [8, 16]
    # a second service on the same weights meets bucket 16 again: only the
    # new bucket is warmed
    second = _StubService(weights, pm, (16, 32))
    serve_common.warm_service(second)
    assert second.warmed == [32]
    # other weights: every bucket again
    other = _StubService({"w": torch.zeros(1)}, pm, (16,))
    serve_common.warm_service(other)
    assert other.warmed == [16]
    calls = []
    key = ("a decode's shape", id(calls))
    assert serve_common.warm(key, lambda: calls.append(1)) is True
    assert serve_common.warm(key, lambda: calls.append(1)) is False
    assert calls == [1]
