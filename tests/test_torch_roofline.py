"""The port's roofline accounting (mmtg_tpu_torch/utils/roofline.py) against
mmtg_tpu.utils.roofline on the CPU: every count equals the JAX function's
number for number, the shares equal a hand computation against the H100's
published peaks, and a device the tables do not know raises. Then
chip_smoke's reading of it: on the H100 80GB HBM3 its kernel bounds are the
figures they were reckoned with before, an unknown card fails phase 1 before
the build, a share outside (0, 1.05] fails, and a decode share counts the
dtypes the call resolved."""

import dataclasses

import pytest
import torch

from mmtg_tpu import configs as jconfigs
from mmtg_tpu.utils import roofline as jroof
from mmtg_tpu_torch import configs as tconfigs
from mmtg_tpu_torch.utils import roofline as troof

from _torch_parity import to_port_config

import chip_smoke

SXM = "NVIDIA H100 80GB HBM3"
UNKNOWN = ("TPU v5 lite", "cpu", "NVIDIA A100-SXM4-80GB")


def _tiny():
    """2 layers, 64-d (the JAX quality tool's model)."""
    gpt2 = jconfigs.GPT2Config(vocab_size=13317, n_positions=256, n_ctx=250,
                               n_embd=64, n_layer=2, n_head=4)
    return (dataclasses.replace(jconfigs.ModelConfig(), gpt2=gpt2),
            jconfigs.DataConfig(wenlan_emb_size=64))


CONFIGS = {
    "default": lambda: (jconfigs.ModelConfig(), jconfigs.DataConfig()),
    "english": jconfigs.english_variant,
    "tiny": _tiny,
}


def _both(name):
    """(JAX mcfg, JAX dcfg, port mcfg, port dcfg) of a named config."""
    jm, jd = CONFIGS[name]()
    return jm, jd, to_port_config(jm), to_port_config(jd)


@pytest.mark.parametrize("name", CONFIGS)
def test_gpt2_param_count_equals_jax(name):
    jm, _, tm, _ = _both(name)
    assert isinstance(tm, tconfigs.ModelConfig)
    assert troof.gpt2_param_count(tm.gpt2) == jroof.gpt2_param_count(jm.gpt2)


def test_gpt2_param_count_is_the_ports_init_at_full_width():
    from mmtg_tpu_torch.params import init_gpt2_params, tree_leaves

    g = tconfigs.ModelConfig().gpt2
    n = sum(p.numel() for p in tree_leaves(init_gpt2_params(g)))
    assert n == troof.gpt2_param_count(g) == 96_069_888


@pytest.mark.parametrize("model_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("weight", ["model", "int8"])
@pytest.mark.parametrize("cache", ["model", "int8", "int4"])
@pytest.mark.parametrize("length", [1, 220])
@pytest.mark.parametrize("B", [1, 8, 64, 512])
@pytest.mark.parametrize("name", CONFIGS)
def test_decode_bytes_model_equals_jax(name, B, length, cache, weight, model_dtype):
    jm, jd, tm, td = _both(name)
    got = troof.decode_bytes_model(tm, td, B, length, cache, weight, model_dtype)
    want = jroof.decode_bytes_model(jm, jd, B, length, cache, weight, model_dtype)
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)


@pytest.mark.parametrize("B", [1, 64, 256])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_flops_model_equals_jax(name, B):
    jm, jd, tm, td = _both(name)
    got, want = troof.train_flops_model(tm, td, B), jroof.train_flops_model(jm, jd, B)
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)


# (config, B, wall s, cache, weight, model dtype): phase 3's and 12's calls
DECODE_CASES = [("default", 64, 0.7777, "int8", "model", "bfloat16"),
                ("default", 8, 2.9, "model", "int8", "bfloat16"),
                ("default", 64, 1.9, "int4", "model", "bfloat16"),
                ("english", 1, 3.3, "model", "int8", "float32"),
                ("tiny", 512, 0.05, "int8", "model", "float32")]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_hbm_util(case):
    name, B, wall, cache, weight, mdt = case
    jm, jd, tm, td = _both(name)
    got = troof.decode_hbm_util(tm, td, B, 220, wall, SXM, cache, weight, mdt)
    want = jroof.decode_hbm_util(jm, jd, B, 220, wall, "TPU v5 lite", cache, weight, mdt)
    for k in ("achieved_gbps", "modeled_bytes_gb", "cache_stream_gb", "weight_read_gb"):
        assert got[k] == want[k], k
    total = troof.decode_bytes_model(tm, td, B, 220, cache, weight, mdt)["total_bytes"]
    assert got["hbm_peak_gbps"] == 3350.0
    assert got["hbm_util"] == round(total / wall / 1e9 / 3350.0, 3)
    assert set(got) == set(want)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", [("default", 64, 0.1436), ("default", 256, 0.4450),
                                  ("english", 64, 0.2), ("tiny", 8, 0.01)], ids=str)
def test_train_mfu(case, remat):
    name, B, step_s = case
    jm, jd, tm, td = _both(name)
    got = troof.train_mfu(tm, td, B, step_s, SXM, remat=remat)
    want = jroof.train_mfu(jm, jd, B, step_s, "TPU v5 lite", remat=remat)
    for k in ("achieved_model_tflops", "model_flops_per_step", "tokens_per_step"):
        assert got[k] == want[k], k
    m = troof.train_flops_model(tm, td, B)
    assert got["peak_bf16_tflops"] == 989.0
    assert got["mfu"] == round(m["model_flops"] / step_s / 989e12, 3)
    hw = m["hw_flops"] if remat else m["model_flops"]
    assert got["hw_flops_util"] == round(hw / step_s / 989e12, 3)
    assert set(got) == set(want)


@pytest.mark.parametrize("kind,hbm,bf16,f32", [
    (SXM, 3350.0, 989.0, 67.0),
    ("NVIDIA H100 PCIe", 2000.0, 756.0, 51.0),
    ("NVIDIA H100 NVL", 3900.0, 835.0, 60.0)])
def test_peaks_of_the_known_cards(kind, hbm, bf16, f32):
    assert troof.peak_hbm_gbps(kind) == hbm
    assert troof.peak_bf16_tflops(kind) == bf16
    assert troof.peak_f32_tflops(kind) == f32


_NEEDS_A_PEAK = {
    "peak_hbm_gbps": lambda k: troof.peak_hbm_gbps(k),
    "peak_bf16_tflops": lambda k: troof.peak_bf16_tflops(k),
    "peak_f32_tflops": lambda k: troof.peak_f32_tflops(k),
    "decode_hbm_util": lambda k: troof.decode_hbm_util(
        tconfigs.ModelConfig(), tconfigs.DataConfig(), 64, 220, 1.0, k),
    "train_mfu": lambda k: troof.train_mfu(
        tconfigs.ModelConfig(), tconfigs.DataConfig(), 64, 0.1, k),
}


@pytest.mark.parametrize("fn", _NEEDS_A_PEAK)
@pytest.mark.parametrize("kind", UNKNOWN)
def test_an_unknown_device_raises(kind, fn):
    with pytest.raises(ValueError, match=kind):
        _NEEDS_A_PEAK[fn](kind)


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "bfloat16"),
                                        (torch.float32, "float32"),
                                        ("int4", "int4"), ("model", "model")])
def test_dtype_name(dtype, name):
    assert troof.dtype_name(dtype) == name


@pytest.mark.parametrize("dtype", ["auto", torch.float16])
def test_an_unresolved_or_unknown_dtype_raises(dtype):
    with pytest.raises(ValueError):
        troof.decode_bytes_model(tconfigs.ModelConfig(), tconfigs.DataConfig(), 8,
                                 220, cache_dtype=dtype)


# ---- chip_smoke's reading of the module -------------------------------------

@pytest.mark.parametrize("nbytes,ops,dname", [(12.41e6, 23.6e6, "bfloat16"),
                                              (100.7e6, 6.5e9, "bfloat16"),
                                              (312.4e6, 11.15e9, "float32")])
def test_chip_smoke_bounds_on_the_sxm_are_unchanged(monkeypatch, nbytes, ops, dname):
    """On the H100 80GB HBM3 a bound is the number it was when the peaks
    were constants of the script (3.35 TB/s, 989 / 67 TFLOP/s)."""
    monkeypatch.setattr(chip_smoke, "device_kind", lambda: SXM)
    b = chip_smoke.bound(nbytes, ops, dname)
    by_bytes = nbytes / 3.35e12 * 1e3
    by_ops = ops / {"bfloat16": 989e12, "float32": 67e12}[dname] * 1e3
    assert b["bound_ms"] == max(by_bytes, by_ops)
    assert b["bound_by"] == ("bytes" if by_bytes >= by_ops else "operations")


def test_chip_smoke_fails_at_phase_1_on_an_unknown_card(monkeypatch):
    from mmtg_tpu_torch.kernels import _build

    def no_build():
        raise AssertionError("the kernels were built for an unknown card")

    monkeypatch.setattr(chip_smoke, "device_kind", lambda: UNKNOWN[2])
    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match=UNKNOWN[2]):
        chip_smoke.phase_build({})


@pytest.mark.parametrize("share,ok", [(0.0, False), (-0.1, False), (1.06, False),
                                      (0.001, True), (1.05, True)])
def test_chip_smoke_fails_a_share_out_of_range(share, ok):
    r = {"mfu": 0.5, "hw_flops_util": share}
    if ok:
        assert chip_smoke.check_shares("t", r, ("mfu", "hw_flops_util")) is r
    else:
        with pytest.raises(RuntimeError, match="hw_flops_util"):
            chip_smoke.check_shares("t", r, ("mfu", "hw_flops_util"))


@pytest.mark.parametrize("B,cache,weight", [(64, "int8", "model"), (8, "int8", "int8"),
                                            (1, "model", "int8")])
def test_chip_smoke_decode_share_counts_the_resolved_dtypes(monkeypatch, B, cache,
                                                            weight):
    """GenerateConfig(cache_dtype="auto", weight_dtype="auto") at phase 3's
    batches: the share counts what the call ran with."""
    monkeypatch.setattr(chip_smoke, "device_kind", lambda: SXM)
    m, d = tconfigs.ModelConfig(), tconfigs.DataConfig()
    gcfg = tconfigs.GenerateConfig(cache_dtype="auto", weight_dtype="auto")
    got = chip_smoke.decode_share("t", gcfg, m, d, B, 2.0, torch.bfloat16)
    assert got == troof.decode_hbm_util(m, d, B, 220, 2.0, SXM, cache, weight,
                                        "bfloat16")
