"""The trace reduction on small canned traces: self times, categories,
busy time, idle gaps by the host's CUDA call, and the wall taken from the
window, not from the device events."""

import pytest

from h100bench import harness, trace

GPU = [
    {"ph": "X", "cat": "kernel", "pid": 1, "tid": 7, "ts": 0, "dur": 10,
     "name": "void decode_attention_kernel<int8>(Args)"},
    {"ph": "X", "cat": "kernel", "pid": 1, "tid": 7, "ts": 20, "dur": 10,
     "name": "matmul_bf16_kernel(Args)"},
    {"ph": "X", "cat": "kernel", "pid": 1, "tid": 8, "ts": 25, "dur": 10,
     "name": "elementwise_kernel<add>"},
    {"ph": "X", "cat": "gpu_memcpy", "pid": 1, "tid": 7, "ts": 50, "dur": 5,
     "name": "Memcpy DtoH (Device -> Pageable)"},
    {"ph": "X", "cat": "cuda_runtime", "pid": 2, "tid": 3, "ts": 12, "dur": 2,
     "name": "cudaLaunchKernel"},
    {"ph": "X", "cat": "cuda_runtime", "pid": 2, "tid": 3, "ts": 36, "dur": 13,
     "name": "cudaStreamSynchronize"},
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "GPU 0"}},
]


def test_gpu_timeline():
    r = trace.parse(GPU, window_s=100e-6)
    assert r["on_gpu"] and r["kernels"] == 3
    # busy: [0, 10] + [20, 35] + [50, 55]
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["window_s"] == 100e-6
    assert r["self_s"]["matmul_bf16_kernel(Args)"] == pytest.approx(10e-6)
    cats = r["categories_s"]
    assert cats["dense matmul (qkv/mlp/proj/lmhead)"] == pytest.approx(10e-6)
    assert cats["attn kernel (CUDA mha_* fwd/bwd, decode_attention)"] == \
        pytest.approx(10e-6)
    assert cats["elementwise fusion"] == pytest.approx(10e-6)
    # gaps [10, 20] under a launch, [35, 50] under a synchronize
    assert r["idle_gaps_s"] == pytest.approx(
        {"cudaLaunchKernel": 10e-6, "cudaStreamSynchronize": 15e-6})


def test_idle_share_reads_the_window():
    r = trace.parse(GPU, window_s=100e-6)
    rec = harness.Record(0.0, {}, 0, 0, 0, {}, True, {}, trace=r,
                         work={"steps": 3})
    idle = harness.metric("generate.idle_share").read(rec)
    assert idle == pytest.approx(70.0)  # 1 - 30 / 100, not 1 - 30 / 55
    assert harness.metric("generate.launches_per_step").read(rec) == 1.0


def test_gap_with_no_call():
    evs = GPU[:2]
    r = trace.parse(evs, window_s=1e-3)
    assert r["idle_gaps_s"] == pytest.approx({trace.IDLE_NO_CALL: 10e-6})


def test_nested_host_ops_count_self_time():
    evs = [{"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 0, "dur": 10,
            "name": "aten::linear"},
           {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 2, "dur": 5,
            "name": "aten::mm"}]
    r = trace.parse(evs, window_s=20e-6)
    assert not r["on_gpu"]
    assert r["self_s"] == pytest.approx({"aten::linear": 5e-6, "aten::mm": 5e-6})
    assert r["busy_s"] == pytest.approx(10e-6)


def test_breakdown_lists():
    b = trace.breakdown(trace.parse(GPU, window_s=100e-6))
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) == 2
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(15e-6)]
