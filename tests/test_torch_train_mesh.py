"""The port's meshed train step (data parallel, tensor parallel, DP x TP and
ZeRO-1 over a gloo process mesh on the CPU) against the JAX package's
single-device train step, f32, dropout off: the same parameters and the same
global batch of 8, whose ratings make the data ranks keep different counts
(at dp = 4 one rank keeps none).

One ``torchrun`` job of four ranks (``tests/_torch_train_mesh_job.py``)
computes every case on the meshes (4, 1), (2, 2), (1, 4) and ZeRO-1 on
(4, 1) and (2, 2), under the remat policy "auto" resolves to (the kept qkv
and attention context), and (2, 2) under "full", into one ``.npz``; it is
launched once for the module with a time limit of its own, and the tests
read it. The model: 2 layers, 12 heads of 8 (6 heads a rank at tp = 2, 3 at
tp = 4), vocab 50."""

import numpy as np
import pytest
import torch

from mmtg_tpu_torch.models.gpt2 import DATA_SALT, MICRO_SALT, TP_SALT, fold_seed
from mmtg_tpu_torch.ops.train_attention import dropout_keep_mask

from _torch_parity import (
    MESH_RATINGS,
    jax_mesh_reference,
    leaf_close,
    mesh_job_inputs,
    mesh_train_setup,
    npz_leaves,
    run_mesh_job,
)

CASES = {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4), "4x1_zero1": (4, 1),
         "2x2_zero1": (2, 2), "2x2_full": (2, 2)}
JOB_TIMEOUT_S = 240
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4  # tests/test_sharding.py's DP-vs-single tolerance


@pytest.fixture(scope="module")
def setup(tokenizer):
    return mesh_train_setup(tokenizer)


@pytest.fixture(scope="module")
def job(setup, tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh_job")
    mesh_job_inputs(setup, str(d / "inputs.pt"))
    return run_mesh_job("_torch_train_mesh_job.py", str(d / "inputs.pt"),
                        str(d / "out.npz"), JOB_TIMEOUT_S)


@pytest.fixture(scope="module")
def jax_ref(setup):
    return jax_mesh_reference(setup)


_leaves = npz_leaves


def test_ratings_keep_different_counts_on_the_data_ranks():
    keep = [r != 3.0 for r in MESH_RATINGS]
    per_rank = {dp: [sum(keep[i * (8 // dp):(i + 1) * (8 // dp)]) for i in range(dp)]
                for dp in (2, 4)}
    assert per_rank == {2: [3, 2], 4: [2, 1, 0, 2]}


@pytest.mark.parametrize("case", CASES)
def test_remat_policy_each_case_ran(job, case):
    """The policy "auto" resolves on the global batch (every data rank's
    rows) to the kept qkv + context at these shapes, under DP, TP and ZeRO-1
    alike."""
    want = "full" if case.endswith("_full") else "save_qkv_ctx"
    assert str(job[f"{case}/policy"][0]) == want


@pytest.mark.parametrize("case", CASES)
def test_loss_and_metrics_equal_jax_single_device(job, jax_ref, case):
    for k in ("loss", "kl", "total", "kept"):
        assert float(job[f"{case}/{k}"][0]) == pytest.approx(
            jax_ref["metrics"][k], abs=1e-5), k
    assert float(job[f"{case}/kept"][0]) == 5.0


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_equals_jax_single_device(job, jax_ref, case):
    got = _leaves(job, f"{case}/grad")
    assert len(got) == len(jax_ref["grads"])
    for g, r in zip(got, jax_ref["grads"]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_clip_norm_is_the_whole_models(job, jax_ref, case):
    want = float(np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                             for g in jax_ref["grads"])))
    assert float(job[f"{case}/norm"][0]) == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_params_and_moments_after_two_steps_equal_jax(job, jax_ref, case):
    assert int(job[f"{case}/count"][0]) == jax_ref["count"] == 2
    for what, tol in (("params", 1e-6), ("mu", 1e-5), ("nu", 1e-5)):
        got = _leaves(job, f"{case}/{what}")
        assert len(got) == len(jax_ref[what])
        for g, r in zip(got, jax_ref[what]):
            assert g.shape == r.shape
            if what == "params":
                assert float(np.abs(g - r).max()) <= tol
            else:
                leaf_close(g, r, tol)


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_bit_equal_on_every_rank(job, case):
    assert bool(job[f"{case}/replicated_equal"][0])


@pytest.mark.parametrize("case", CASES)
def test_zero_kept_batch_is_a_noop_on_every_rank(job, case):
    assert float(job[f"{case}/zero_kept"][0]) == 0.0
    assert bool(job[f"{case}/zero_kept_noop"][0])
    assert int(job[f"{case}/zero_kept_step"][0]) == 3


@pytest.mark.parametrize("case,dp", [("4x1_zero1", 4), ("2x2_zero1", 2)])
def test_zero1_moments_hold_one_dp_th_a_rank(job, case, dp):
    mine, local = (int(x) for x in job[f"{case}/moment_numel"])
    assert mine == -(-local // dp)


def test_dropout_residual_masks_shared_by_tp_ranks_attention_masks_not(job):
    """(2, 2), ranks (d, m) at 2d + m: the embedding and residual seeds are
    one data shard's on both its TP ranks and differ across data ranks; the
    attention seeds differ on every rank, and so do the masks they draw."""
    seeds = job["dropout/seeds"]  # [rank, 1 + 2L + L]
    L = 2
    shared, attn = seeds[:, :1 + 2 * L], seeds[:, 1 + 2 * L:]
    np.testing.assert_array_equal(shared[0], shared[1])
    np.testing.assert_array_equal(shared[2], shared[3])
    assert (shared[0] != shared[2]).all()
    assert len({tuple(a) for a in attn}) == 4
    masks = [dropout_keep_mask(torch.tensor([int(a[0])], dtype=torch.int32), 1, 6,
                               128, 0.1) for a in attn]
    for i in range(4):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])


def test_dropout_residual_stream_bit_equal_across_tp_ranks(job):
    hidden = job["dropout/hidden"]  # [rank, B/dp, T, D]
    np.testing.assert_array_equal(hidden[0], hidden[1])
    np.testing.assert_array_equal(hidden[2], hidden[3])
    assert not np.array_equal(hidden[0], hidden[2])  # other rows, other masks
    assert np.isfinite(hidden).all()


def test_fold_seed_separates_indices_and_salts():
    salts = (TP_SALT, MICRO_SALT, DATA_SALT)
    got = {fold_seed(12345, k, s) for k in range(64) for s in salts}
    assert len(got) == 64 * len(salts) and all(0 <= x < 2 ** 31 for x in got)
    assert fold_seed(12345, 3, TP_SALT) == fold_seed(12345, 3, TP_SALT)
