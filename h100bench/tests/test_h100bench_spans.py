"""The span reduction (``spans.attribute``) on small canned traces: a
device event goes to the innermost span open at its launch, whatever
thread launched it; an idle gap to the innermost span open over most of
it; the rest is unattributed. On the card (``-m cuda``): a span around one
hand-written kernel call holds that launch's runtime event and no other,
and a traced small-batch ``generate`` is put down to its spans."""

import pytest
import torch

from h100bench import spans, trace


def _span(name, ts, dur, i, parent=0):
    return {"ph": "X", "cat": spans.SPAN_CAT, "name": name, "pid": 1,
            "tid": 1 << 30, "ts": ts, "dur": dur,
            "args": {"id": i, "parent": parent, "call": 1, "thread": 10}}


def _launch(ts, corr, tid=10):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 1, "tid": tid, "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


SPANS = [_span("decode.call", 0, 100, 1), _span("decode.step", 10, 40, 2, 1),
         _span("decode.sample", 12, 8, 3, 2), _span("decode.embed", 21, 3.5, 4, 2),
         _span("decode.model", 25, 20, 5, 2)]
DEVICE = [
    _launch(13, 1), _kernel("sort_kernel", 14, 3, 1),            # sample
    _launch(30, 2, tid=99), _kernel("decode_attention_kernel", 31, 4, 2),
    _launch(36, 6), _kernel("matmul_bf16_kernel", 40, 4, 6),     # model
    _launch(60, 3), _kernel("elementwise_kernel", 62, 5, 3),     # call's own
    _launch(150, 4), _kernel("late_kernel", 151, 2, 4),         # no span
    _kernel("orphan_kernel", 160, 1, 5),                        # no launch
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
     "pid": 1, "tid": 10, "ts": 70, "dur": 80, "args": {"correlation": 7}},
]


def test_device_time_goes_to_the_span_of_its_launch():
    r = spans.attribute(SPANS + DEVICE)
    assert r["device_by_span_s"] == pytest.approx(
        {"decode.sample": 3e-6, "decode.model": 8e-6, "decode.call": 5e-6})
    # the kernel launched from another thread (tid 99) inside decode.model
    assert r["device_by_span_op_s"]["decode.model | decode_attention_kernel"] == \
        pytest.approx(4e-6)
    assert r["device_under_span_s"] == pytest.approx(
        {"decode.sample": 3e-6, "decode.model": 8e-6, "decode.step": 11e-6,
         "decode.call": 16e-6})
    assert r["unattributed_s"] == pytest.approx(3e-6)  # late + orphan
    assert r["span_counts"] == {"decode.call": 1, "decode.step": 1,
                                "decode.sample": 1, "decode.embed": 1,
                                "decode.model": 1}


def test_idle_gaps_go_to_the_innermost_span_open_over_most_of_them():
    r = spans.attribute(SPANS + DEVICE)
    # [17, 31]: its middle lies in decode.embed (21-24.5, under half of
    # it), so it goes up to decode.step; [35, 40] inside decode.model;
    # [44, 62] in decode.call alone; [67, 151] mostly outside every span;
    # [153, 160] outside
    assert r["idle_by_span_s"] == pytest.approx(
        {"decode.step": 14e-6, "decode.model": 5e-6, "decode.call": 18e-6,
         spans.OUTSIDE: 91e-6})
    assert r["idle_by_span_call_s"][f"{spans.OUTSIDE} | cudaStreamSynchronize"] == \
        pytest.approx(84e-6)
    # the same gaps as trace.parse finds, and its keys unmoved by the spans
    parsed = trace.parse(SPANS + DEVICE, window_s=200e-6)
    assert parsed == trace.parse(DEVICE, window_s=200e-6)
    assert sum(r["idle_by_span_s"].values()) == \
        pytest.approx(sum(parsed["idle_gaps_s"].values()))


@pytest.mark.parametrize("events", [DEVICE, SPANS[:1] + DEVICE[8:10]],
                         ids=["no spans", "span before the launch"])
def test_the_rest_is_unattributed(events):
    r = spans.attribute(events)
    dev = sum(float(e["dur"]) for e in events if e["cat"] == "kernel") / 1e6
    assert r["device_by_span_s"] == {}
    assert r["unattributed_s"] == pytest.approx(dev)


def test_readings_per_step_and_the_warm_call():
    from mmtg_tpu_torch.utils.logging import Span

    t = {"device_under_span_s": {"decode.sample": 0.2, "decode.model": 1.1,
                                 "decode.setup": 0.05, "train.forward": 0.5},
         "span_counts": {"decode.sample": 200, "decode.model": 220,
                         "decode.setup": 1},
         "stretch_span_ids": [3]}
    every = [Span("decode.call", 0, 9 * 10 ** 9, 1, 0, 1, 1),
             Span("decode.call", 10 ** 10, 10 ** 10 + 5 * 10 ** 9, 2, 0, 1, 2),
             Span("decode.call", 2 * 10 ** 10, 2 * 10 ** 10 + 6 * 10 ** 9, 3, 0, 1, 3),
             Span("decode.call", 3 * 10 ** 10, 3 * 10 ** 10 + 5 * 10 ** 9, 4, 0, 1, 4)]
    got = spans.readings(t, every)
    assert got == pytest.approx({
        "generate.sample_ms_per_step": 1.0, "generate.model_ms_per_step": 5.0,
        "generate.setup_ms": 50.0, "generate.warm_call_extra_s": 4.0})
    assert "train.forward_ms" not in got  # no train.step span to count by


@pytest.mark.parametrize("t, why", [
    ({"busy_s": 1.0, "unattributed_s": 0.0, "span_counts": {}}, "no span"),
    ({"busy_s": 1.0, "unattributed_s": 0.02, "span_counts": {"decode.call": 1}},
     "over 1%"),
    ({"busy_s": 1.0, "unattributed_s": 0.01, "span_counts": {"decode.call": 1}},
     None),
], ids=["no spans", "unattributed over 1%", "readable"])
def test_fault_refuses_a_stretch_the_spans_do_not_cover(t, why):
    got = spans.fault(t)
    assert got is None if why is None else why in got


def test_fault_reads_the_reduction_of_a_canned_trace():
    t = trace.parse(SPANS + DEVICE, window_s=200e-6)
    t.update(spans.attribute(SPANS + DEVICE))
    assert "unattributed" in spans.fault(t)  # 3 of 23 us outside the spans
    t.update(spans.attribute(SPANS + DEVICE[:8]))
    assert spans.fault(t) is None


def test_span_category_is_the_programs():
    from mmtg_tpu_torch.utils import logging

    assert spans.SPAN_CAT == logging.SPAN_CAT


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_span_holds_its_kernels_launch_and_no_other(card):
    from mmtg_tpu_torch.ops.layer_norm import layer_norm_rows
    from mmtg_tpu_torch.utils.logging import span

    x = torch.randn(64, 768, device=card, dtype=torch.bfloat16)
    g, b = torch.ones(768, device=card, dtype=x.dtype), torch.zeros_like(x[0])
    layer_norm_rows(x, g, b, 1e-5)  # the library loaded, outside the trace
    box = {}

    def work():
        y = x * 2
        with span("one.kernel"):
            box["out"] = layer_norm_rows(y, g, b, 1e-5)
        box["z"] = box["out"] + 1

    t = spans.traced(work, card)
    assert t["span_counts"] == {"one.kernel": 1}
    ops = [k for k in t["device_by_span_op_s"] if k.startswith("one.kernel | ")]
    assert len(ops) == 1 and "layer_norm" in ops[0]
    assert t["unattributed_s"] > 0  # the two eager ops around it


@pytest.mark.cuda
def test_traced_generate_is_put_down_to_its_spans(card):
    from h100bench import harness, seeded
    from mmtg_tpu_torch import decoding
    from mmtg_tpu_torch.configs import GenerateConfig

    cfg = harness.config("mmtg_zh")
    m, d = cfg["model"], cfg["data"]
    mcfg, dcfg = harness.model_configs(cfg)
    params = seeded.make_weights(m, 5, card, torch.bfloat16)
    const = {"wenlan_table": seeded.make_table(
        m["gpt2"]["vocab_size"], d["wenlan_emb_size"], 5, card, torch.bfloat16)}
    batch = seeded.generate_batch(16, d, m, 5, 0, card, torch.bfloat16)
    gcfg = GenerateConfig(batch_size=16, top_k=10, top_p=0.7)
    gen = torch.Generator(device=card).manual_seed(1)
    decoding.generate(params, const, mcfg, dcfg, gcfg, batch, gen)  # warm
    t = spans.traced(lambda: decoding.generate(params, const, mcfg, dcfg, gcfg,
                                               batch, gen), card)
    assert t["span_counts"]["decode.sample"] == 200
    assert t["span_counts"]["decode.model"] == 220
    assert t["unattributed_s"] <= 0.01 * t["busy_s"]
    attn = {k.split(" | ")[0]: v for k, v in t["device_by_span_op_s"].items()
            if "decode_attention" in k}
    assert list(attn) == ["decode.model"]
    # the spans and the rest account for the busy time (the events' own
    # times can overlap a little, and the union is summed on the trace's
    # large absolute stamps)
    assert sum(t["device_by_span_s"].values()) + t["unattributed_s"] == \
        pytest.approx(t["busy_s"], rel=1e-2)
