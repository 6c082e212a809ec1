"""The port's span recorder (``utils/logging.span``, ``record_spans``): off
it records nothing; on, spans nest with their parents and call ids, share
the profiler trace's clock, mark the decode loop, the train step and the
kernel library's set-up by their names, and never wait for the card."""

import json
import threading
import time

import pytest
import torch

from mmtg_tpu_torch import decoding, train
from mmtg_tpu_torch.configs import (ChannelConfig, DataConfig, GenerateConfig,
                                    GPT2Config, ModelConfig, TrainConfig)
from mmtg_tpu_torch.kernels import _build
from mmtg_tpu_torch.params import init_params
from mmtg_tpu_torch.utils import logging as ulog
from mmtg_tpu_torch.utils.logging import maybe_profile, record_spans, span

B = 2
MCFG = ModelConfig(
    topic=ChannelConfig(input_dim=16, hidden_dim=8, type="MLP"),
    image=ChannelConfig(input_dim=16, hidden_dim=8),
    text=ChannelConfig(input_dim=16, hidden_dim=8),
    self_att_hidden_size=8, self_att_heads=2, mm_att_out_dim=16, dropout=0.0,
    gpt2=GPT2Config(vocab_size=150, n_positions=256, n_ctx=250, n_embd=16,
                    n_layer=1, n_head=2, resid_pdrop=0.0, embd_pdrop=0.0,
                    attn_pdrop=0.0))
DCFG = DataConfig(wenlan_emb_size=16)


def _names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    P, E, V = DCFG.topic_prompt_length, DCFG.wenlan_emb_size, MCFG.gpt2.vocab_size
    batch = {
        "topic_ids": torch.randint(104, V, (B, P), generator=g, dtype=torch.int32),
        "tpw_attention_mask": torch.ones(B, P, dtype=torch.int32),
        "tpw_type_ids": torch.ones(B, P, dtype=torch.int32),
        "topic_emb": torch.randn(B, E, generator=g),
        "img_embs": torch.randn(B, MCFG.seq_len, E, generator=g),
        "r_embs": torch.randn(B, MCFG.seq_len, E, generator=g),
    }
    const = {"wenlan_table": torch.randn(V, E, generator=g)}
    return init_params(MCFG, seed=1), const, batch


def test_off_records_nothing():
    assert span("decode.step") is span("train.step")  # one shared no-op
    with span("decode.step"):
        pass
    with record_spans() as got:
        pass
    assert got == [] and ulog._REC.names == [] and not ulog._REC.on


def test_nesting_parents_and_call_ids():
    with record_spans() as got:
        with span("a"):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e"):
            pass
    by = {s.name: s for s in got}
    assert [s.name for s in got] == ["c", "b", "d", "a", "e"]  # in order of ending
    assert by["a"].parent == 0 and by["e"].parent == 0
    assert by["b"].parent == by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    assert {by[n].call for n in "abcd"} == {by["a"].id} != {by["e"].call}
    for s in got:
        assert s.start_ns <= s.end_ns and s.thread == threading.get_native_id()
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].end_ns <= by["a"].end_ns


def test_blocks_nest_and_threads_keep_their_own_stacks():
    def worker():
        with span("t"):
            pass

    with record_spans() as outer:
        with span("x"):
            with record_spans() as inner:
                with span("y"):
                    pass
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    assert [s.name for s in inner] == ["y"]
    assert sorted(_names(outer)) == ["t", "x", "y"]
    t = next(s for s in outer if s.name == "t")
    assert t.parent == 0 and t.call == t.id  # another thread: a call of its own
    assert ulog._REC.names == [] and len(ulog._REC.fields) == 0


def test_thread_id_is_read_once_a_thread(monkeypatch):
    reads = []
    real = threading.get_native_id
    monkeypatch.setattr(threading, "get_native_id",
                        lambda: reads.append(1) or real())

    def worker():
        reads.clear()  # the thread's own start reads it too
        for _ in range(3):
            with span("t"):
                pass

    with record_spans() as got:
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert len(got) == 3 and len({s.thread for s in got}) == 1 and len(reads) == 1


def test_threads_recording_at_once_keep_each_span_whole():
    """More threads than cores, switching as often as the interpreter can:
    every span keeps its own name, thread and stamps."""
    import os
    import sys

    n = max(8, 2 * (os.cpu_count() or 1))

    def worker(i):
        for _ in range(500):
            with span(f"t{i}"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with record_spans() as got:
            ths = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert len(got) == 500 * n and len({s.id for s in got}) == 500 * n
    by_name = {}
    for s in got:
        assert s.start_ns <= s.end_ns and s.parent == 0 and s.call == s.id
        assert by_name.setdefault(s.name, s.thread) == s.thread
    assert len(by_name) == n


def test_recording_leaves_nothing_for_the_garbage_collector():
    """Finished spans are kept in untracked storage: a young-generation
    collection set off inside a traced call was what recording cost."""
    import gc

    gc.disable()
    try:
        with record_spans() as got:
            before = gc.get_count()[0]
            for _ in range(1000):
                with span("decode.step"):
                    with span("decode.model"):
                        pass
            after = gc.get_count()[0]
    finally:
        gc.enable()
    assert len(got) == 2000 and after - before < 10


@pytest.mark.parametrize("via", ["stamps", "maybe_profile"])
def test_spans_share_the_profiler_clock(tmp_path, via):
    """A span around one aten op holds that op's event in the profiler's
    Chrome trace: its own ns stamps against the trace's ``ts`` plus
    ``baseTimeNanoseconds``, and the span that ``maybe_profile`` writes into
    the trace (its "program spans" row) against the trace's ``ts``."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    path = tmp_path / "trace.json"

    def one_mm():  # 2 ms of margin on each side: the clocks agree closer
        with span("one.mm"):
            time.sleep(2e-3)
            torch.mm(a, a)
            time.sleep(2e-3)

    if via == "stamps":
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                record_spans() as got:
            one_mm()
        prof.export_chrome_trace(str(path))
    else:
        with maybe_profile(str(tmp_path)):
            one_mm()
        (path,) = tmp_path.glob("trace_*.json")
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    if via == "stamps":
        (s,) = got
        base = int(trace.get("baseTimeNanoseconds", 0))
        lo, hi = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
    else:
        (sp,) = [e for e in events if e.get("cat") == ulog.SPAN_CAT]
        assert sp["name"] == "one.mm" and sp["pid"] == mm["pid"]
        assert sp["tid"] >= ulog.SPAN_TID
        (row,) = [e for e in events if e.get("ph") == "M"
                  and e.get("tid") == sp["tid"]]
        assert row["args"]["name"].startswith("program spans")
        lo, hi = sp["ts"], sp["ts"] + sp["dur"]
    assert lo <= mm["ts"] and mm["ts"] + mm["dur"] <= hi


def test_maybe_profile_leaves_a_trace_without_spans_as_exported(tmp_path,
                                                                 monkeypatch):
    """No span recorded: the profiler's own file is left as it wrote it,
    not read back and rewritten."""
    wrote = []
    real_dump = json.dump
    monkeypatch.setattr(json, "dump", lambda *a, **k: wrote.append(1)
                        or real_dump(*a, **k))
    a = torch.randn(64, 64)
    with maybe_profile(str(tmp_path)):
        torch.mm(a, a)
    (path,) = tmp_path.glob("trace_*")
    events = json.loads(path.read_text())["traceEvents"]
    assert not wrote and any(e.get("name") == "aten::mm" for e in events)
    assert not [e for e in events if e.get("cat") == ulog.SPAN_CAT]


def test_generate_marks_every_step(model):
    params, const, batch = model
    gcfg = GenerateConfig(top_k=5, cache_dtype="int8", weight_dtype="int8")
    with record_spans() as got:
        toks = decoding.generate(params, const, MCFG, DCFG, gcfg, batch,
                                 torch.Generator().manual_seed(3))
    assert toks.shape == (B, gcfg.length + 1) == (B, 221)
    assert _names(got) == {"decode.call": 1, "decode.setup": 1,
                           "decode.step": 220, "decode.sample": 200,
                           "decode.embed": 220, "decode.model": 220}
    call = next(s for s in got if s.name == "decode.call")
    assert {s.call for s in got} == {call.id}
    ids = {s.id: s for s in got}
    for s in got:
        want = {"decode.call": None, "decode.setup": "decode.call",
                "decode.step": "decode.call"}.get(s.name, "decode.step")
        assert (ids[s.parent].name if s.parent else None) == want


def test_generate_stream_marks_a_call_a_block(model):
    params, const, batch = model
    gcfg = GenerateConfig(top_k=5, length=44, cache_dtype="model",
                          weight_dtype="model")
    with record_spans() as got:
        blocks = list(decoding.generate_stream(
            params, const, MCFG, DCFG, gcfg, batch,
            torch.Generator().manual_seed(3), chunk=22))
    assert len(blocks) == 2
    n = _names(got)
    # the set-up's call, then one a block
    assert n["decode.call"] == 3 and n["decode.setup"] == 1 and n["decode.step"] == 44
    assert len({s.call for s in got}) == 3


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_marks_forward_backward_and_optimizer(model, grad_accum):
    params, const, batch = model
    g = torch.Generator().manual_seed(5)
    Tt, V = DCFG.max_seq_length + 1, MCFG.gpt2.vocab_size
    tb = dict(batch,
              targets=torch.randint(104, V, (B, Tt), generator=g, dtype=torch.int32),
              attention_mask=torch.ones(B, Tt, dtype=torch.int32),
              type_ids=torch.randint(0, 5, (B, Tt), generator=g, dtype=torch.int32),
              rating=torch.tensor([4.0, 5.0]), sample_mask=torch.ones(B))
    tcfg = TrainConfig(batch_size=B, grad_accum=grad_accum, remat=True)
    state, tx = train.create_train_state(0, MCFG, tcfg, 1, 10, params=params,
                                         device="cpu")
    step = train.make_train_step(MCFG, DCFG, tcfg, tx)
    with record_spans() as got:
        state, _ = step(state, const, tb, 3)
    assert _names(got) == {"train.step": 1, "train.forward": grad_accum,
                           "train.backward": grad_accum, "train.optimizer": 1}
    top = next(s for s in got if s.name == "train.step")
    assert all(s.parent == top.id and s.call == top.id for s in got if s is not top)
    fwd = sorted(s.start_ns for s in got if s.name == "train.forward")
    bwd = sorted(s.start_ns for s in got if s.name == "train.backward")
    assert all(f < b for f, b in zip(fwd, bwd))


@pytest.mark.parametrize("stage", ["load", "build"])
def test_kernel_library_setup_spans(monkeypatch, tmp_path, stage):
    """The first ``load`` is a ``kernels.load`` span and a compile a
    ``kernels.build`` one inside it, even when the compile fails."""
    def no_nvcc():
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    if stage == "load":
        monkeypatch.setattr(_build, "build", lambda: str(tmp_path / "none.so"))
    with record_spans() as got, pytest.raises(OSError if stage == "load"
                                              else RuntimeError):
        _build.load()
    want = {"kernels.load": 1} if stage == "load" else {"kernels.load": 1,
                                                         "kernels.build": 1}
    assert _names(got) == want


def test_recording_never_waits_for_the_card(model, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    params, const, batch = model
    gcfg = GenerateConfig(top_k=5, length=30)
    with record_spans() as got:
        decoding.generate(params, const, MCFG, DCFG, gcfg, batch,
                          torch.Generator().manual_seed(3))
    assert got and calls == []
