"""The port's GPipe train path (``parallel.pipeline`` over a gloo process
mesh of data 2 x pipe 2 on the CPU, 2 micro-batches a rank) against the JAX
package's single-device train and eval steps, f32, dropout off, on the same
parameters and global batch as ``tests/test_torch_train_mesh.py``.

One ``torchrun`` job of four ranks (``tests/_torch_pipeline_job.py``) is
launched once for the module with a time limit of its own; the tests read
its ``.npz``. The layer-count and ``return_kv`` errors need no processes."""

import numpy as np
import pytest
import torch

from mmtg_tpu_torch.configs import GPT2Config
from mmtg_tpu_torch.models.gpt2 import gpt2_forward
from mmtg_tpu_torch.params import init_gpt2_params
from mmtg_tpu_torch.parallel.pipeline import pipeline_stack, shard_params_pp

from _torch_parity import (
    jax_mesh_reference,
    leaf_close,
    mesh_job_inputs,
    mesh_train_setup,
    npz_leaves,
    run_mesh_job,
)

JOB_TIMEOUT_S = 240
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4


@pytest.fixture(scope="module")
def setup(tokenizer):
    return mesh_train_setup(tokenizer)


@pytest.fixture(scope="module")
def job(setup, tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline_job")
    mesh_job_inputs(setup, str(d / "inputs.pt"))
    return run_mesh_job("_torch_pipeline_job.py", str(d / "inputs.pt"),
                        str(d / "out.npz"), JOB_TIMEOUT_S)


@pytest.fixture(scope="module")
def jax_ref(setup):
    return jax_mesh_reference(setup)


def test_each_stage_holds_half_the_layers(job):
    assert int(job["local_layers"][0]) == 1


def test_pipelined_eval_loss_equals_jax(job, jax_ref):
    """tests/test_pipeline.py's bar: the deterministic pipelined eval equals
    the unsharded one."""
    for k in ("loss", "kl", "total"):
        assert float(job[f"eval/{k}"][0]) == pytest.approx(jax_ref["eval"][k],
                                                           rel=2e-6), k
    assert float(job["eval/kept"][0]) == jax_ref["eval"]["kept"] == 5.0


def test_every_gradient_leaf_equals_jax(job, jax_ref):
    got = npz_leaves(job, "grad")
    assert len(got) == len(jax_ref["grads"])
    for g, r in zip(got, jax_ref["grads"]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    want = float(np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                             for g in jax_ref["grads"])))
    assert float(job["norm"][0]) == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("policy", ["full", "save_qkv_ctx", "save_ctx_fc1", "save_all"])
def test_every_remat_policy_gives_the_pipeline_the_same_numbers(job, policy):
    """The stages recompute from their inputs whatever the policy (as the JAX
    trainer resolves "auto" to "full" there): an explicit policy changes no
    gradient and no metric on any rank."""
    assert bool(job[f"policy/{policy}"][0])


@pytest.mark.parametrize("what,tol", [("params", 1e-6), ("mu", 1e-5), ("nu", 1e-5)])
def test_two_steps_move_the_params_as_jax(job, jax_ref, what, tol):
    assert float(job["moved"][0]) > 1e-6
    got = npz_leaves(job, what)
    assert len(got) == len(jax_ref[what])
    for g, r in zip(got, jax_ref[what]):
        if what == "params":
            assert float(np.abs(g - r).max()) <= tol
        else:
            leaf_close(g, r, tol)


def test_replicated_leaves_identical_on_every_stage(job):
    assert bool(job["replicated_equal"][0])


def test_zero_kept_batch_is_a_noop(job):
    assert float(job["zero_kept"][0]) == 0.0 and bool(job["zero_kept_noop"][0])


def test_dropout_deterministic_for_a_seed_and_distinct_across_micro_batches(job):
    assert bool(job["dropout/same_seed_equal"][0])
    assert bool(job["dropout/other_seed_differs"][0])
    # micro-batch 1 repeats micro-batch 0's rows: equal without dropout,
    # different masks with it
    assert bool(job["dropout/off_micro_batches_equal"][0])
    assert bool(job["dropout/micro_batches_differ"][0])


def test_layer_count_must_divide_by_the_stages():
    cfg = GPT2Config(vocab_size=64, n_positions=16, n_ctx=16, n_embd=16, n_layer=3,
                     n_head=2)
    params = {"gpt2": init_gpt2_params(cfg, seed=0)}
    with pytest.raises(ValueError, match="not divisible by pipe=2"):
        shard_params_pp(params, 2, 0)
    assert shard_params_pp(params, 3, 1)["gpt2"]["h"]["attn_w"].shape[0] == 1


def test_pipeline_rejects_return_kv_and_segments():
    cfg = GPT2Config(vocab_size=64, n_positions=16, n_ctx=16, n_embd=16, n_layer=2,
                     n_head=2)
    params = init_gpt2_params(cfg, seed=0)
    x = torch.zeros(2, 4, 16)
    pos = torch.arange(4)[None, :]
    for kw in (dict(return_kv=True), dict(segment_ids=torch.zeros(2, 4))):
        with pytest.raises(ValueError, match="train-path only"):
            gpt2_forward(params, cfg, x, pos, pp=(object(), 2), **kw)


def test_micro_batches_must_divide_the_rank_batch():
    with pytest.raises(ValueError, match="n_micro=3"):
        pipeline_stack(None, {}, torch.zeros(4, 2, 2), [], None, 3)
