"""The port's serving layer (mmtg_tpu_torch/serve.py) on the CPU at the
conftest tiny config: the drills of tests/test_serve.py that need no mesh.

The contract under test: a request's tokens depend only on (service base
seed, request seed) — never on what it was batched with or how the batch was
padded — and a streamed response equals the batched one. Every service is
stopped (both threads joined) before its test ends, and every test runs under
its own time limit (``limit``: SIGALRM in the test's thread)."""

import concurrent.futures
import dataclasses
import io
import json
import pickle
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmtg_tpu.data import MMTGDataset, make_synthetic_records
from mmtg_tpu_torch import decoding, serve
from mmtg_tpu_torch.configs import GenerateConfig, SpecialTokens
from mmtg_tpu_torch.ops import prng
from mmtg_tpu_torch.params import init_params
from mmtg_tpu_torch.serve import (SAMPLE_KEYS, GenerationService,
                                  ServiceOverloaded, serve_http)

from _torch_parity import to_port_config

torch.set_num_threads(2)
START = SpecialTokens().start_id


@pytest.fixture(autouse=True)
def limit():
    """Each test's own time limit: 120 s, then it fails instead of hanging."""
    def on_alarm(signum, frame):
        raise TimeoutError("test exceeded its 120 s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def no_thread_left_behind():
    before = {t for t in threading.enumerate()}
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.name.startswith("mmtg-") and t.is_alive()]
    assert not left, f"service threads still alive: {left}"


@pytest.fixture(scope="module")
def serve_setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    mcfg, dcfg = to_port_config(tiny_model_cfg), to_port_config(tiny_data_cfg)
    rng = np.random.default_rng(13)
    records = make_synthetic_records(4, rng, emb_size=dcfg.wenlan_emb_size)
    ds = MMTGDataset.from_records(records, tokenizer, tiny_data_cfg, if_train=False)
    V = mcfg.gpt2.vocab_size
    samples = []
    for i in range(len(ds)):
        row = {k: np.asarray(v) for k, v in ds[i].items()}
        row["topic_ids"] = np.minimum(row["topic_ids"], V - 1)
        samples.append(row)
    params = init_params(mcfg, seed=3)
    table = torch.from_numpy(
        rng.standard_normal((V, dcfg.wenlan_emb_size)).astype(np.float32))
    gcfg = GenerateConfig(length=46, top_k=8, top_p=0.7, temperature=1.1,
                          repetition_penalty=1.5)
    return params, {"wenlan_table": table}, mcfg, dcfg, gcfg, samples


def _direct(params, const, mcfg, dcfg, gcfg, samples, seeds, base_seed=0):
    batch = {k: torch.from_numpy(np.stack([np.asarray(s[k]) for s in samples]))
             for k in SAMPLE_KEYS}
    return decoding.generate(params, const, mcfg, dcfg, gcfg, batch,
                             prng.PRNGKey(base_seed),
                             row_seeds=torch.tensor(seeds, dtype=torch.int32)).numpy()


def _service(setup, **kw):
    params, const, mcfg, dcfg, gcfg, _ = setup
    kw.setdefault("base_seed", 0)
    return GenerationService(params, const, mcfg, dcfg, kw.pop("gcfg", gcfg), **kw)


def test_npz_request_codec_roundtrip():
    rng = np.random.default_rng(0)
    sample = {
        "topic_ids": rng.integers(0, 100, 15).astype(np.int32),
        "tpw_attention_mask": np.ones(15, np.int32),
        "tpw_type_ids": np.zeros(15, np.int32),
        "topic_emb": rng.standard_normal(32).astype(np.float32),
        "img_embs": rng.standard_normal((5, 32)).astype(np.float32),
        "r_embs": rng.standard_normal((5, 32)).astype(np.float32),
    }
    got, meta = serve.decode_request_npz(serve.encode_request_npz(sample))
    assert meta == {"seed": 0, "timeout": 600.0, "text": True}
    assert set(got) == set(sample)
    for k in sample:
        np.testing.assert_array_equal(got[k], sample[k])
        assert got[k].dtype == sample[k].dtype
    _, meta = serve.decode_request_npz(
        serve.encode_request_npz(sample, seed=42, timeout=5.0, text=False))
    assert meta == {"seed": 42, "timeout": 5.0, "text": False}
    # the JAX package's codec reads the port's bytes and the other way round
    from mmtg_tpu import serve as jserve

    body = serve.encode_request_npz(sample, seed=7)
    assert jserve.decode_request_npz(body)[1]["seed"] == 7
    assert serve.decode_request_npz(jserve.encode_request_npz(sample, seed=8))[1]["seed"] == 8
    buf = io.BytesIO()  # an object array must not deserialize
    np.savez(buf, evil=np.asarray({"a": 1}, dtype=object))
    with pytest.raises(ValueError):
        serve.decode_request_npz(buf.getvalue())


def test_prometheus_metrics_renders_stats():
    stats = {
        "requests": 7, "batches": 3, "padded_rows": 2, "served": 6,
        "tokens_served": 1200, "rejected": 1, "cancelled": 0, "errors": 0,
        "mean_fill": 0.75, "mean_batch": 2.0, "uptime_s": 10.0,
        "tokens_per_s": 120.0, "p50_latency_ms": 500.0, "p95_latency_ms": 900.0,
    }
    text = serve.prometheus_metrics(stats)
    from mmtg_tpu.serve import prometheus_metrics as jax_metrics

    assert text == jax_metrics(stats)  # the same exposition text
    assert "mmtg_requests_total 7" in text
    assert "# TYPE mmtg_window_fill_ratio gauge" in text
    assert 'mmtg_request_latency_seconds{quantile="0.5"} 0.5' in text
    text2 = serve.prometheus_metrics({"requests": 0})
    assert "latency" not in text2 and "mmtg_requests_total 0" in text2


def test_bucket_choice_and_padding(serve_setup):
    svc = _service(serve_setup, buckets=(2, 4, 8))
    assert [svc._bucket_for(n) for n in (1, 2, 3, 4, 5, 8, 9)] == [2, 2, 4, 4, 8, 8, 8]
    samples = serve_setup[5]
    reqs = [serve._Pending(samples[i], 10 + i, concurrent.futures.Future())
            for i in range(3)]
    batch, seeds = svc._pack(reqs, 4)
    assert seeds.tolist() == [10, 11, 12, 0] and seeds.dtype == torch.int32
    assert all(batch[k].shape[0] == 4 for k in SAMPLE_KEYS)
    # the pad row repeats row 0
    assert torch.equal(batch["topic_emb"][3], batch["topic_emb"][0])
    assert batch["topic_ids"].dtype == torch.int32
    with pytest.raises(ValueError):
        _service(serve_setup, buckets=(4, 2))
    with pytest.raises(NotImplementedError, match="parallelism"):
        _service(serve_setup, buckets=(2,), mesh=object())


def test_service_batches_and_matches_direct(serve_setup):
    """Concurrent submits merge into one padded bucket and each response
    equals the direct engine run for its (sample, seed)."""
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    svc = _service(serve_setup, buckets=(4,), max_wait_ms=2000.0)
    with svc:
        futs = [svc.submit(samples[i], seed=100 + i) for i in range(3)]
        # a 4th request fills the bucket, so the window closes at once
        futs.append(svc.submit(samples[3], seed=103))
        got = [f.result(timeout=100) for f in futs]
    direct = _direct(params, const, mcfg, dcfg, gcfg, samples, [100, 101, 102, 103])
    for i in range(4):
        np.testing.assert_array_equal(got[i], direct[i])
        assert got[i].dtype == np.int32 and got[i][0] == START
    st = svc.stats()
    assert st["requests"] == 4 and st["batches"] == 1 and st["padded_rows"] == 0
    assert st["p50_latency_ms"] > 0 and st["pending"] == 0


def test_response_is_independent_of_its_batch(serve_setup):
    """The same request returns identical tokens served alone (bucket 2, one
    pad row) or batched with two others (bucket 4)."""
    samples = serve_setup[5]
    svc = _service(serve_setup, buckets=(2, 4), max_wait_ms=300.0)
    with svc:
        batched = [svc.submit(samples[i], seed=5) for i in range(3)]
        batched = [f.result(timeout=100) for f in batched]
    assert svc.stats()["padded_rows"] == 1
    svc2 = _service(serve_setup, buckets=(2, 4), max_wait_ms=0.0)
    with svc2:
        solo = svc2.generate_sync(samples[0], seed=5)
    np.testing.assert_array_equal(batched[0], solo)


def test_service_validates_samples_and_masks_seeds(serve_setup):
    samples = serve_setup[5]
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=0.0)
    bad = dict(samples[0])
    bad.pop("topic_emb")
    with pytest.raises(ValueError, match="missing keys"):
        svc._validate(bad)
    with pytest.raises(ValueError, match="topic_ids shape"):
        svc._validate({**samples[0], "topic_ids": samples[0]["topic_ids"][:-1]})
    with pytest.raises(ValueError, match="img_embs shape"):
        svc._validate({**samples[0], "img_embs": np.asarray(samples[0]["img_embs"])[:-1]})
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(samples[0], seed=1)
    with svc:
        big = svc.generate_sync(samples[0], seed=2 ** 40)  # & 0xFFFFFFFF == 0
        zero = svc.generate_sync(samples[0], seed=0)
        neg = svc.generate_sync(samples[0], seed=-1)
        wrapped = svc.generate_sync(samples[0], seed=2 ** 32 - 1)
    np.testing.assert_array_equal(big, zero)
    np.testing.assert_array_equal(neg, wrapped)


def test_cancelled_request_is_skipped(serve_setup):
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    svc = _service(serve_setup, buckets=(2, 4), max_wait_ms=400.0)
    with svc:
        f_keep = svc.submit(samples[0], seed=40)
        f_cancel = svc.submit(samples[1], seed=41)
        assert f_cancel.cancel()
        kept = f_keep.result(timeout=100)
    with pytest.raises(concurrent.futures.CancelledError):
        f_cancel.result(timeout=1)
    np.testing.assert_array_equal(
        kept, _direct(params, const, mcfg, dcfg, gcfg, [samples[0]], [40])[0])
    assert svc.stats()["cancelled"] == 1


def test_stop_serves_already_submitted_requests(serve_setup):
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    svc = _service(serve_setup, buckets=(4,), max_wait_ms=500.0).start()
    futs = [svc.submit(samples[i], seed=60 + i) for i in range(3)]
    svc.stop()  # joins both threads; the sentinel sits behind the queued work
    got = [f.result(timeout=1) for f in futs]
    direct = _direct(params, const, mcfg, dcfg, gcfg, samples[:3], [60, 61, 62])
    for i in range(3):
        np.testing.assert_array_equal(got[i], direct[i])
    st = svc.stats()
    assert st["tokens_served"] == 3 * gcfg.length and st["served"] == 3


def test_overload_sheds_at_the_edge(serve_setup):
    samples = serve_setup[5]
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=0.0, max_queue_depth=0)
    with svc:
        with pytest.raises(ServiceOverloaded, match="max_queue_depth"):
            svc.submit(samples[0], seed=1)
        it = svc.stream(samples[0], 1)
        assert svc.stats()["requests"] == 0  # lazy: nothing enqueued yet
        with pytest.raises(ServiceOverloaded, match="max_queue_depth"):
            next(it)
        with pytest.raises(ValueError, match="shape"):  # eager shape check
            svc.stream({**samples[0], "topic_emb": np.zeros(3)}, 0)
    assert svc.stats()["rejected"] == 2


def test_swap_params_hot_reload(serve_setup):
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=0.0)
    other = init_params(mcfg, seed=99)
    with svc:
        before = svc.generate_sync(samples[0], seed=3)
        # numpy leaves in f64: cast to the serving dtype on the way in
        from mmtg_tpu_torch.params import tree_map

        svc.swap_params(tree_map(lambda t: t.double().numpy(), other))
        after = svc.generate_sync(samples[0], seed=3)
        again = svc.generate_sync(samples[0], seed=3)
    assert (before != after).any()
    np.testing.assert_array_equal(after, again)
    np.testing.assert_array_equal(
        after, _direct(other, const, mcfg, dcfg, gcfg, [samples[0]], [3])[0])
    assert svc.params["gpt2"]["wte"].dtype == torch.float32
    bad = {k: v for k, v in params.items() if k != "projector1"}
    with pytest.raises(ValueError, match="do not match"):
        svc.swap_params(bad)


def test_decode_fault_fails_window_cleanly(serve_setup):
    samples = serve_setup[5]
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=0.0)
    real_decode, real_chunked = svc._decode, svc._decode_chunked

    def faulty(batch, seeds):
        raise RuntimeError("injected decode fault (drill)")

    def faulty_stream(batch, seeds):
        yield next(real_chunked(batch, seeds))
        raise RuntimeError("injected stream fault (drill)")

    with svc:
        want = svc.generate_sync(samples[0], seed=11)
        svc._decode = faulty
        with pytest.raises(RuntimeError, match="injected decode fault"):
            svc.submit(samples[0], seed=12).result(timeout=60)
        svc._decode_chunked = faulty_stream  # a fault after the first block
        it = svc.stream(samples[0], seed=12)
        assert next(it).size == 22
        with pytest.raises(RuntimeError, match="injected stream fault"):
            list(it)
        svc._decode, svc._decode_chunked = real_decode, real_chunked
        got = svc.generate_sync(samples[0], seed=11)
    np.testing.assert_array_equal(got, want)
    st = svc.stats()
    assert st["errors"] == 2 and st["pending"] == 0


# the batcher thread dies of the injected error: that is the drill
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_death_drains_and_restart_serves(serve_setup):
    samples = serve_setup[5]
    svc = _service(serve_setup, buckets=(1,), max_wait_ms=0.0)

    class EngineDeath(BaseException):
        pass

    def dying(batch, seeds):
        raise EngineDeath("injected engine death (drill)")

    svc._decode = dying
    svc.start()
    failures = 0
    for i in range(4):
        try:
            fut = svc.submit(samples[i % len(samples)], seed=20 + i)
        except RuntimeError:
            failures += 1
            continue
        with pytest.raises((RuntimeError, EngineDeath)):
            fut.result(timeout=60)
        failures += 1
    assert failures == 4
    svc._thread.join(30)
    with pytest.raises(RuntimeError, match="engine is down"):
        svc.submit(samples[0], seed=30)
    svc.stop()  # must not deadlock on the collector join
    healthy = _service(serve_setup, buckets=(1,), max_wait_ms=0.0)
    with healthy:
        want = healthy.generate_sync(samples[0], seed=31)
    restarted = _service(serve_setup, buckets=(1,), max_wait_ms=0.0)
    with restarted:
        got = restarted.generate_sync(samples[0], seed=31)
    np.testing.assert_array_equal(got, want)


def test_stream_matches_batched(serve_setup):
    gcfg, samples = serve_setup[4], serve_setup[5]
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=0.0)
    with svc:
        blocks = list(svc.stream(samples[1], seed=9))
        ragged = list(svc.stream(samples[1], seed=9, chunk=10))
        batched = svc.generate_sync(samples[1], 9)
    assert [b.size for b in blocks] == [22, 22, 2]
    assert [b.size for b in ragged] == [10, 10, 10, 10, 6]
    for got in (blocks, ragged):
        np.testing.assert_array_equal(
            np.concatenate([[START], np.concatenate(got)]), batched)
    st = svc.stats()
    assert st["streams"] == 2 and st["stream_tokens"] == 2 * gcfg.length


def test_stream_shares_window_with_batched(serve_setup):
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    svc = _service(serve_setup, buckets=(3,), max_wait_ms=5000.0)
    stream_out = {}

    def consume(idx, seed):
        stream_out[idx] = list(svc.stream(samples[idx], seed))

    with svc:
        threads = [threading.Thread(target=consume, args=(i, 20 + i)) for i in (0, 1)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30  # both streams are in the open window
        while svc.stats()["requests"] < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        batched = svc.submit(samples[2], seed=22).result(timeout=100)  # fills it
        for t in threads:
            t.join(timeout=100)
            assert not t.is_alive()
    direct = _direct(params, const, mcfg, dcfg, gcfg, samples[:3], [20, 21, 22])
    np.testing.assert_array_equal(batched, direct[2])
    for i in (0, 1):
        assert len(stream_out[i]) == 3
        np.testing.assert_array_equal(
            np.concatenate([[START], np.concatenate(stream_out[i])]), direct[i])
    st = svc.stats()
    assert st["batches"] == 1 and st["streams"] == 2 and st["served"] == 3
    assert st["stream_tokens"] == 2 * gcfg.length


def test_stream_hangup_window_completes(serve_setup):
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=2000.0)
    with svc:
        it = svc.stream(samples[0], 1)
        first = [None]
        t = threading.Thread(target=lambda: first.__setitem__(0, next(it)))
        t.start()
        deadline = time.monotonic() + 30
        while svc.stats()["requests"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        fut = svc.submit(samples[1], seed=2)  # fills the window
        t.join(timeout=100)
        it.close()  # hang up after one sentence
        mate = fut.result(timeout=100)  # batch-mate unharmed
        direct = _direct(params, const, mcfg, dcfg, gcfg, [samples[1]], [2])
        np.testing.assert_array_equal(mate, direct[0])
        assert first[0].size == dcfg.sent_frame_length
        assert svc.stats()["stream_tokens"] == gcfg.length
        np.testing.assert_array_equal(svc.generate_sync(samples[1], 2), direct[0])


def test_service_resolves_auto_dtypes_once(serve_setup):
    gcfg = serve_setup[4]
    auto_w = dataclasses.replace(gcfg, weight_dtype="auto")
    assert _service(serve_setup, gcfg=auto_w, buckets=(2, 8)).gcfg.weight_dtype == "int8"
    assert _service(serve_setup, gcfg=auto_w, buckets=(2, 48)).gcfg.weight_dtype == "model"
    auto_c = dataclasses.replace(gcfg, cache_dtype="auto")
    assert _service(serve_setup, gcfg=auto_c, buckets=(1, 8)).gcfg.cache_dtype == "int8"
    assert _service(serve_setup, gcfg=auto_c, buckets=(1,)).gcfg.cache_dtype == "model"
    pinned = dataclasses.replace(gcfg, cache_dtype="int4", weight_dtype="model")
    svc = _service(serve_setup, gcfg=pinned, buckets=(1,))
    assert (svc.gcfg.cache_dtype, svc.gcfg.weight_dtype) == ("int4", "model")


def test_stall_clock_restarts_when_work_arrives_at_an_idle_service(serve_setup):
    """The repair of the reference's stall-clock fault: a request that arrives
    after a long idle time must not read the idle time as a stall."""
    samples = serve_setup[5]
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=0.0, stall_unhealthy_s=5.0)
    entered, release = threading.Event(), threading.Event()
    real = svc._decode

    def held(batch, seeds):
        entered.set()
        release.wait(60)
        return real(batch, seeds)

    svc._decode = held
    with svc:
        assert svc.stats()["stalled_s"] == 0.0  # idle: no stall whatever the clock
        svc._last_progress -= 3600.0  # "the last window completed an hour ago"
        assert svc.stats()["stalled_s"] == 0.0
        fut = svc.submit(samples[0], seed=1)
        st = svc.stats()  # pending now, and the clock restarted at the submit
        assert st["pending"] >= 1 and st["stalled_s"] < 5.0
        assert entered.wait(30)
        # work IS pending and the decode hangs: the clock runs from the window
        svc._last_progress -= 100.0
        assert svc.stats()["stalled_s"] >= 100.0
        # a second request while one is pending does not reset it
        fut2 = svc.submit(samples[1], seed=2)
        assert svc.stats()["stalled_s"] >= 100.0
        release.set()
        fut.result(timeout=100)
        fut2.result(timeout=100)
    assert svc.stats()["stalled_s"] == 0.0


def test_stall_detection_and_wedged_stop(serve_setup):
    samples = serve_setup[5]
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=5.0, stall_unhealthy_s=0.05)
    release = threading.Event()

    class _Hang:
        """Stands in for the decoded value; bringing it to the host blocks
        like a device call that never returns."""
        def __array__(self, dtype=None, copy=None):
            release.wait(60.0)
            raise RuntimeError("wedge released")

    svc._decode = lambda batch, seeds: _Hang()
    collector = None
    try:
        svc.start()
        collector = svc._collector
        fut = svc.submit(samples[0], seed=1)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = svc.stats()
            if st["stalled_s"] > svc.stall_unhealthy_s and st["pending"] >= 1:
                break
            time.sleep(0.01)
        else:
            raise AssertionError(f"never stalled: {svc.stats()}")
        t0 = time.monotonic()
        svc.stop(join_timeout_s=0.2)  # must not hang on the wedged collector
        assert time.monotonic() - t0 < 10
        assert "wedged" in str(svc._engine_error)
    finally:
        release.set()
        if collector is not None:
            collector.join(30)
    with pytest.raises(Exception):
        fut.result(timeout=5)


def _post(port, path, body, ctype="application/json", timeout=100):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture
def http_service(serve_setup, tokenizer):
    svc = _service(serve_setup, buckets=(2,), max_wait_ms=0.0).start()
    httpd = serve_http(svc, port=0, tokenizer=tokenizer)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield svc, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    t.join(30)
    svc.stop()


def test_http_front(serve_setup, http_service):
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    svc, port = http_service
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}
    body = json.dumps({"sample": {k: np.asarray(v).tolist()
                                  for k, v in samples[0].items()}, "seed": 5}).encode()
    code, _, raw = _post(port, "/generate", body)
    out = json.loads(raw)
    direct = _direct(params, const, mcfg, dcfg, gcfg, [samples[0]], [5])
    assert code == 200
    np.testing.assert_array_equal(np.asarray(out["tokens"]), direct[0])
    assert isinstance(out["text"], str) and out["seed"] == 5
    # binary npz body: the same tokens from a smaller payload, by content
    # type and by the zip magic alone
    nbody = serve.encode_request_npz(samples[0], seed=5)
    assert len(nbody) < len(body)
    for ctype in (serve.NPZ_CONTENT_TYPE, "application/octet-stream"):
        code, _, raw = _post(port, "/generate", nbody, ctype)
        assert code == 200 and json.loads(raw)["tokens"] == out["tokens"]
    assert _post(port, "/generate", nbody[:100], serve.NPZ_CONTENT_TYPE)[0] == 400
    assert _post(port, "/generate", json.dumps({"sample": {}}).encode())[0] == 400
    assert _post(port, "/nowhere", b"{}")[0] == 404
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
        st = json.loads(r.read())
    assert st["requests"] >= 3 and st["batches"] >= 3
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE mmtg_requests_total counter" in text
    # a stalled service reads unhealthy
    svc.stall_unhealthy_s = -1.0
    svc._inflight_count += 1  # "a window is pending"
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30)
        assert err.value.code == 503
    finally:
        svc._inflight_count -= 1


def test_http_stream_endpoint(serve_setup, http_service):
    params, const, mcfg, dcfg, gcfg, samples = serve_setup
    _, port = http_service
    body = json.dumps({"sample": {k: np.asarray(v).tolist()
                                  for k, v in samples[0].items()}, "seed": 5}).encode()
    code, ctype, raw = _post(port, "/generate_stream", body)
    assert code == 200 and ctype == "text/event-stream"
    events = [json.loads(ev[len("data: "):])
              for ev in raw.decode("utf-8").split("\n\n") if ev.startswith("data: ")]
    assert events[-1]["done"] is True and events[-1]["tokens_total"] == gcfg.length
    assert [len(ev["tokens"]) for ev in events[:-1]] == [22, 22, 2]
    assert all(isinstance(ev["text"], str) for ev in events[:-1])
    toks = [t for ev in events[:-1] for t in ev["tokens"]]
    direct = _direct(params, const, mcfg, dcfg, gcfg, [samples[0]], [5])
    np.testing.assert_array_equal(np.asarray([START] + toks), direct[0])
    assert _post(port, "/generate_stream", b"{not json")[0] == 400


@pytest.fixture(scope="module")
def cli_artifacts(tmp_path_factory, serve_setup, reference_vocab_path):
    from mmtg_tpu_torch.checkpoint import save_reference_checkpoint

    params, _, mcfg, dcfg, _, _ = serve_setup
    d = tmp_path_factory.mktemp("serve_cli")
    paths = {"a": str(d / "a.pth"), "b": str(d / "b.pth"), "emb": str(d / "emb.pkl"),
             "vocab": reference_vocab_path}
    save_reference_checkpoint(paths["a"], params, mcfg)
    save_reference_checkpoint(paths["b"], init_params(mcfg, seed=99), mcfg)
    rng = np.random.default_rng(0)
    with open(paths["emb"], "wb") as f:
        pickle.dump({i: rng.standard_normal(dcfg.wenlan_emb_size).astype(np.float32)
                     for i in range(0, 13317, 7)}, f)
    return paths


def _cli_args(paths, *extra):
    return ["--model_path", paths["a"], "--tokenizer_path", paths["vocab"],
            "--token_emb_path", paths["emb"], "--buckets", "2,4", "--max_wait_ms",
            "0", "--device", "cpu", *extra]


def test_serve_cli_build_service_and_reload(serve_setup, cli_artifacts):
    """The CLI wiring: parsed args -> tokenizer, checkpoint, table, buckets ->
    a started service that answers over HTTP; POST /reload swaps the weights
    for the next window."""
    _, _, mcfg, dcfg, _, samples = serve_setup
    args = serve.build_arg_parser().parse_args(_cli_args(cli_artifacts, "--seed", "3"))
    service, tok = serve.build_service(args, mcfg=mcfg, dcfg=dcfg)
    httpd = serve_http(service, port=0, tokenizer=tok)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert service.buckets == (2, 4) and service.device.type == "cpu"
        assert service.gcfg.length == dcfg.max_seq_length
        assert service.gcfg.weight_dtype == "int8"  # auto, largest bucket 4
        port = httpd.server_address[1]
        nbody = serve.encode_request_npz(samples[0], seed=1)
        code, _, raw = _post(port, "/generate", nbody, serve.NPZ_CONTENT_TYPE)
        before = json.loads(raw)
        assert code == 200 and len(before["tokens"]) == dcfg.max_seq_length + 1
        code, _, raw = _post(port, "/reload",
                             json.dumps({"model_path": cli_artifacts["b"]}).encode())
        assert code == 200 and json.loads(raw)["ok"] is True
        after = json.loads(_post(port, "/generate", nbody, serve.NPZ_CONTENT_TYPE)[2])
        assert after["tokens"] != before["tokens"]
        # a path that is no checkpoint: 400, and the service keeps its weights
        assert _post(port, "/reload", json.dumps({"model_path": "/x/dir"}).encode())[0] == 400
        assert _post(port, "/reload", b"{}")[0] == 400
        again = json.loads(_post(port, "/generate", nbody, serve.NPZ_CONTENT_TYPE)[2])
        assert again["tokens"] == after["tokens"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(30)
        service.stop()


def test_serve_cli_flags(serve_setup, cli_artifacts, monkeypatch):
    _, _, mcfg, dcfg, _, _ = serve_setup
    parse = serve.build_arg_parser().parse_args
    for extra in (("--mesh_data", "2"), ("--mesh_model", "2")):
        with pytest.raises(NotImplementedError, match="parallelism"):
            serve.build_service(parse(_cli_args(cli_artifacts, *extra)), mcfg, dcfg)
    # no --device and no GPU: raises rather than serve from the CPU unasked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = parse([a for a in _cli_args(cli_artifacts) if a not in ("--device", "cpu")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.build_service(args, mcfg, dcfg)
    # the serving decode flags reach the service's config
    args = parse(_cli_args(cli_artifacts, "--cache_dtype", "int8", "--merged_kv",
                           "--attn_impl", "fused", "--weight_dtype", "model"))
    service, _ = serve.build_service(args, mcfg, dcfg)
    try:
        g = service.gcfg
        assert (g.cache_dtype, g.merged_kv, g.attn_impl) == ("int8", True, "fused")
        service.warmup(bucket=2)  # one-shot and chunked, through the merged cache
    finally:
        service.stop()
