"""Tensor-parallel products folded in the one device's order, on the CPU.

* ``matmul_plain``'s two modes: a product chained over its K halves or
  quarters (``partial_out``, then ``acc_in``) is the whole product's f32
  fold within 1e-6, and rounding once gives the whole product.
* The plans: at the repo's width (D = 768) the full plan's K ranges cut at
  the row shards of tp = 2, 3 and 4 for both row-parallel products, column
  shards keep the full plan's ranges, and a (K, tp) that does not cut raises
  (``shard_plan``, ``parallel/mesh.check_row_shards``).
* One gloo job of two ranks (``tests/_torch_tp_fold_job.py``, a (1, 2) mesh,
  f32): ``generate_sharded`` with row seeds gives the single-device
  ``generate``'s tokens row for row; ``models/gpt2.tp_sum`` folds a product
  over the ranks within 1e-6 of the whole product's largest entry, one count
  a product;
  ``shard_decode_params`` raises for bf16 shards of the tiny width."""

import os

import numpy as np
import pytest
import torch

from mmtg_tpu.data import MMTGDataset, make_synthetic_records
from mmtg_tpu_torch import decoding
from mmtg_tpu_torch.configs import GenerateConfig
from mmtg_tpu_torch.ops import matmul as mm
from mmtg_tpu_torch.ops import prng
from mmtg_tpu_torch.params import init_params, tree_to
from mmtg_tpu_torch.parallel import mesh as pmesh

from _torch_parity import BATCH_KEYS, run_torchrun, to_port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SM = mm.REFERENCE_SM_COUNT
D = 768
ROW_PARALLEL = {"attn_proj": (D, D), "mlp_proj": (4 * D, D)}
COLUMN_PARALLEL = {"qkv": (D, 3 * D), "mlp_fc": (D, 4 * D)}
B, LENGTH, KEY = 4, 30, 3
SEEDS = np.arange(B, dtype=np.int64) * 3 + 1
JOB_TIMEOUT_S = 120


def _chain(x, w, parts, bias=None):
    """``x @ w (+ bias)`` as ``parts`` ranks compute it: each K slice's f32
    partial continues the one before it; the last rounds once."""
    k = w.shape[0] // parts
    acc = None
    for r in range(parts):
        last = r == parts - 1
        acc = mm.matmul_plain(x[:, r * k:(r + 1) * k], w[r * k:(r + 1) * k],
                              bias if last else None, acc_in=acc, partial_out=not last)
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [2, 4])
def test_plain_chain_of_k_parts_equals_the_whole_fold(dtype, parts):
    g = torch.Generator().manual_seed(parts)
    x = torch.randn(9, 256, generator=g).to(dtype)
    w = (torch.randn(256, 40, generator=g) * 0.1).to(dtype)
    b = torch.randn(40, generator=g).to(dtype)
    whole = mm.matmul_plain(x, w, partial_out=True)
    assert whole.dtype == torch.float32
    k = 256 // parts
    acc = None
    for r in range(parts - 1):
        acc = mm.matmul_plain(x[:, r * k:(r + 1) * k], w[r * k:(r + 1) * k], acc_in=acc,
                              partial_out=True)
    acc = mm.matmul_plain(x[:, -k:], w[-k:], acc_in=acc, partial_out=True)
    assert acc.dtype == torch.float32
    assert (acc - whole).abs().max().item() <= 1e-6 * whole.abs().max().item()
    got = _chain(x, w, parts, b)
    ref = mm.matmul_plain(x, w, b)
    assert got.dtype == dtype and got.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    else:  # one bf16 rounding of the same sum, then the bias's
        assert (got.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * ref.float().abs().max().item()


def test_modes_refuse_what_they_do_not_take():
    x, w = torch.ones(3, 8), torch.ones(8, 4)
    with pytest.raises(ValueError, match="no bias"):
        mm.matmul_plain(x, w, torch.ones(4), partial_out=True)
    with pytest.raises(ValueError, match="acc_in"):
        mm.matmul_plain(x, w, acc_in=torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="acc_in"):
        mm.matmul_plain(x, w, acc_in=torch.zeros(3, 5))
    with pytest.raises(ValueError, match="not a batch"):
        mm.matmul(torch.ones(2, 3, 8), torch.ones(2, 8, 4), partial_out=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(ROW_PARALLEL))
def test_full_width_row_shards_run_the_full_plans_ranges(dtype, tp, name):
    """Each rank's ranges are the full plan's over its K slice: laid end to
    end they are the full plan's ranges (bf16; one FMA chain in f32)."""
    K, N = ROW_PARALLEL[name]
    assert mm.row_shards_align(K, N, dtype, SM, tp)
    full = mm.plan(K, N, dtype, SM)
    shard = mm.shard_plan(K // tp, N, dtype, SM, (K, N))
    assert (shard.path, shard.bn, shard.bk, shard.slots) == (full.path, full.bn, full.bk,
                                                             full.slots)
    laid = tuple((r * (K // tp) + a, r * (K // tp) + b) for r in range(tp)
                 for a, b in shard.ranges)
    if dtype == torch.bfloat16:
        assert laid == full.ranges
        assert len(full.ranges) % tp == 0 and shard.spr == full.spr
    else:
        assert full.ranges == ((0, K),) and shard.ranges == ((0, K // tp),)


def test_the_repos_row_parallel_plans():
    """What the plans are at D = 768 on 132 SMs (bf16): 12 ranges of one
    64-value stage (attn_proj) and of four (mlp_proj)."""
    a = mm.plan(D, D, torch.bfloat16, SM)
    p = mm.plan(4 * D, D, torch.bfloat16, SM)
    assert (len(a.ranges), a.spr * a.bk) == (12, 64)
    assert (len(p.ranges), p.spr * p.bk) == (12, 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(COLUMN_PARALLEL))
def test_column_shards_keep_the_full_plans_ranges(dtype, tp, name):
    K, N = COLUMN_PARALLEL[name]
    full = mm.plan(K, N, dtype, SM)
    shard = mm.shard_plan(K, N // tp, dtype, SM, (K, N))
    assert shard.ranges == full.ranges and shard.spr == full.spr
    assert shard.bn in mm.TILE_WIDTHS or dtype == torch.float32
    # the shard's own plan would have summed in another tree (bf16)
    if dtype == torch.bfloat16:
        assert mm.plan(K, N // tp, dtype, SM).ranges != full.ranges or tp == 1


def test_row_shards_that_do_not_cut_raise(tiny_model_cfg):
    # bf16 at the tiny width: K = 48 is one 64-value stage, one range
    assert not mm.row_shards_align(48, 48, torch.bfloat16, SM, 2)
    with pytest.raises(ValueError, match="does not cut"):
        mm.shard_plan(24, 48, torch.bfloat16, SM, (48, 48))
    # f32: one FMA chain over k continues at any cut
    assert mm.row_shards_align(48, 48, torch.float32, SM, 2)
    # a card of 114 SMs plans mlp_proj in 10 ranges of 320: two shards of
    # 1536 do not cut there; the 132-SM card's 12 ranges of 256 do
    assert not mm.row_shards_align(4 * D, D, torch.bfloat16, 114, 2)
    assert mm.row_shards_align(4 * D, D, torch.bfloat16, 132, 2)
    with pytest.raises(ValueError, match="neither a column nor a row shard"):
        mm.shard_plan(100, 30, torch.float32, SM, (768, 60))
    params = init_params(to_port_config(tiny_model_cfg), seed=1)
    pmesh.check_row_shards(params, 2)  # f32
    pmesh.check_row_shards(params, 1)
    with pytest.raises(ValueError, match="do not cut"):
        pmesh.check_row_shards(tree_to(params, dtype=torch.bfloat16), 2)


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    mcfg, dcfg = to_port_config(tiny_model_cfg), to_port_config(tiny_data_cfg)
    rng = np.random.default_rng(19)
    records = make_synthetic_records(B, rng, emb_size=dcfg.wenlan_emb_size)
    ds = MMTGDataset.from_records(records, tokenizer, tiny_data_cfg, if_train=False)
    batch = next(ds.batches(batch_size=B))
    V = mcfg.gpt2.vocab_size
    batch["topic_ids"] = np.minimum(batch["topic_ids"], V - 1)
    table = rng.standard_normal((V, dcfg.wenlan_emb_size)).astype(np.float32)
    g = torch.Generator().manual_seed(5)
    return dict(mcfg=mcfg, dcfg=dcfg, params=init_params(mcfg, seed=7),
                const={"wenlan_table": torch.from_numpy(table)},
                batch={k: torch.from_numpy(batch[k]) for k in BATCH_KEYS},
                gcfg=GenerateConfig(length=LENGTH, top_k=5, cache_dtype="model",
                                    weight_dtype="model"),
                x=torch.randn(6, 192, generator=g), w=torch.randn(192, 48, generator=g) * 0.1,
                b=torch.randn(48, generator=g))


@pytest.fixture(scope="module")
def job(setup, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_fold_job")
    inputs, out = str(d / "inputs.pt"), str(d / "out.npz")
    torch.save(dict(setup, row_seeds=torch.from_numpy(SEEDS), key_seed=KEY), inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = run_torchrun(2, [os.path.join(REPO, "tests", "_torch_tp_fold_job.py"), inputs,
                            out], JOB_TIMEOUT_S, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_gloo_1x2_f32_generate_sharded_equals_generate(setup, job):
    want = decoding.generate(setup["params"], setup["const"], setup["mcfg"], setup["dcfg"],
                             setup["gcfg"], setup["batch"], prng.PRNGKey(KEY),
                             row_seeds=torch.from_numpy(SEEDS)).numpy()
    assert job["seeds"].shape == (B, LENGTH + 1)
    np.testing.assert_array_equal(job["seeds"], want)


def test_tp_sum_folds_the_whole_product(setup, job):
    want = mm.matmul_plain(setup["x"], setup["w"], setup["b"]).numpy()
    np.testing.assert_allclose(job["fold"], want, atol=1e-6 * np.abs(want).max(), rtol=0)
    assert int(job["fold_calls"]) == 1


def test_shard_decode_params_raises_where_the_plan_does_not_cut(job):
    err = str(job["bf16_error"])
    assert "do not cut" in err and "attn_proj_w" in err
