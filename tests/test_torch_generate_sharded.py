"""The port's sharded decode (``decoding.generate_sharded`` /
``generate_stream_sharded`` over a gloo process mesh on the CPU) against the
JAX package's ``generate_sharded`` on the conftest 8-device CPU mesh, and
against the port's single-device ``generate``, on the conftest tiny model in
f32 (4 heads of 12: one head a rank at tp = 4).

One ``torchrun`` job of four ranks (``tests/_torch_mesh_job.py``) computes
every case on the meshes (4, 1), (2, 2) and (1, 4) into one ``.npz``; it is
launched once for the module with a time limit of its own, and the tests
read it."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.configs import GenerateConfig as JGenerateConfig
from mmtg_tpu.data import MMTGDataset, make_synthetic_records
from mmtg_tpu.decoding import generate_sharded as jax_generate_sharded
from mmtg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmtg_tpu_torch import decoding
from mmtg_tpu_torch.configs import GenerateConfig
from mmtg_tpu_torch.ops import prng
from mmtg_tpu_torch.params import init_params, to_numpy

from _torch_parity import BATCH_KEYS, run_torchrun, to_port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((4, 1), (2, 2), (1, 4))
B, LENGTH, KEY = 8, 30, 3
SEEDS = np.arange(B, dtype=np.int32) * 5 + 2
JOB_TIMEOUT_S = 150
LOGIT_TOL = 1e-5  # f32: the row-parallel sums run in another order


def _gcfg(**kw):
    return {**dict(length=LENGTH, top_k=5, cache_dtype="model",
                   weight_dtype="model"), **kw}


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    mcfg, dcfg = to_port_config(tiny_model_cfg), to_port_config(tiny_data_cfg)
    rng = np.random.default_rng(11)
    records = make_synthetic_records(B, rng, emb_size=dcfg.wenlan_emb_size)
    ds = MMTGDataset.from_records(records, tokenizer, tiny_data_cfg, if_train=False)
    batch = next(ds.batches(batch_size=B))
    V = mcfg.gpt2.vocab_size
    batch["topic_ids"] = np.minimum(batch["topic_ids"], V - 1)
    np_batch = {k: batch[k] for k in BATCH_KEYS}
    params = init_params(mcfg, seed=3)
    table = rng.standard_normal((V, dcfg.wenlan_emb_size)).astype(np.float32)
    return dict(
        jmcfg=tiny_model_cfg, jdcfg=tiny_data_cfg, mcfg=mcfg, dcfg=dcfg,
        params=params, const={"wenlan_table": torch.from_numpy(table)},
        batch={k: torch.from_numpy(v) for k, v in np_batch.items()},
        jparams=jax.tree.map(jnp.asarray, to_numpy(params)),
        jconst={"wenlan_table": jnp.asarray(table)},
        jbatch={k: jnp.asarray(v) for k, v in np_batch.items()},
    )


def _single(setup, **kw):
    return decoding.generate(
        setup["params"], setup["const"], setup["mcfg"], setup["dcfg"],
        GenerateConfig(**_gcfg(**kw)), setup["batch"], prng.PRNGKey(KEY),
        row_seeds=torch.from_numpy(SEEDS)).numpy()


@pytest.fixture(scope="module")
def single(setup):
    return _single(setup)


@pytest.fixture(scope="module")
def job(setup, single, tmp_path_factory):
    """The port's cases on every mesh, from one gloo job of four ranks."""
    d = tmp_path_factory.mktemp("mesh_job")
    inputs, out = str(d / "inputs.pt"), str(d / "out.npz")
    torch.save(dict(mcfg=setup["mcfg"], dcfg=setup["dcfg"],
                    gcfg=GenerateConfig(**_gcfg()), params=setup["params"],
                    const=setup["const"], batch=setup["batch"],
                    row_seeds=torch.from_numpy(SEEDS), key_seed=KEY,
                    reference_tokens=torch.from_numpy(single)), inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = run_torchrun(4, [os.path.join(REPO, "tests", "_torch_mesh_job.py"), inputs,
                            out], JOB_TIMEOUT_S, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _jax_sharded(setup, shape, row_seeds):
    gcfg = JGenerateConfig(**_gcfg(attn_impl="xla"))
    mesh = jax_make_mesh(shape)
    with mesh:
        return np.asarray(jax_generate_sharded(
            setup["jparams"], setup["jconst"], setup["jmcfg"], setup["jdcfg"], gcfg,
            setup["jbatch"], jax.random.PRNGKey(KEY), mesh,
            row_seeds=None if row_seeds is None else jnp.asarray(row_seeds)))


def _folded_single(setup, dp):
    """The data-folded streams on one device: shard d's rows from
    ``fold_in(key, d)``, one ``generate`` a shard."""
    n = B // dp
    gcfg = GenerateConfig(**_gcfg())
    return np.concatenate([decoding.generate(
        setup["params"], setup["const"], setup["mcfg"], setup["dcfg"], gcfg,
        {k: v[d * n:(d + 1) * n] for k, v in setup["batch"].items()},
        prng.fold_in(prng.PRNGKey(KEY), d)).numpy() for d in range(dp)])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_row_seeds_equal_jax_sharded_and_single_device(setup, job, single, shape):
    name = f"{shape[0]}x{shape[1]}"
    got = job[f"{name}/seeds"]
    assert got.shape == (B, LENGTH + 1) and got.dtype == np.int32
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, _jax_sharded(setup, shape, SEEDS))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_data_fold_equals_jax_sharded_and_single_device(setup, job, shape):
    """Without row seeds each data shard folds the key with its index."""
    got = job[f"{shape[0]}x{shape[1]}/fold"]
    np.testing.assert_array_equal(got, _folded_single(setup, shape[0]))
    np.testing.assert_array_equal(got, _jax_sharded(setup, shape, None))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_torch_generator_seeds_one_stream_a_data_shard(setup, job, shape):
    """A ``torch.Generator``: rank 0's base seed (drawn from it, broadcast)
    seeds one generator a data shard — the same on the shard's TP ranks."""
    dp = shape[0]
    base = int(torch.randint(0, 2 ** 62, (1,),
                             generator=torch.Generator().manual_seed(KEY)))
    n = B // dp
    want = np.concatenate([decoding.generate(
        setup["params"], setup["const"], setup["mcfg"], setup["dcfg"],
        GenerateConfig(**_gcfg()),
        {k: v[d * n:(d + 1) * n] for k, v in setup["batch"].items()},
        torch.Generator().manual_seed((base + 0x9E3779B97F4A7C15 * (d + 1)) % 2 ** 63)
    ).numpy() for d in range(dp)])
    np.testing.assert_array_equal(job[f"{shape[0]}x{shape[1]}/generator"], want)


@pytest.mark.parametrize("case", ["seeds", "fold"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stream_sharded_equals_one_shot(job, shape, case):
    name = f"{shape[0]}x{shape[1]}"
    np.testing.assert_array_equal(job[f"{name}/stream_{case}"],
                                  job[f"{name}/{case}"][:, 1:])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_int8_weights_sharded_equal_one_rank(setup, job, shape):
    """Under TP the row-parallel scales are reduced with MAX over the model
    group, so the sharded int8 weights are the unsharded ones."""
    np.testing.assert_array_equal(job[f"{shape[0]}x{shape[1]}/int8_weights"],
                                  _single(setup, weight_dtype="int8"))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_quantized_cache_under_tp_is_not_streamable(job, shape):
    err = str(job[f"{shape[0]}x{shape[1]}/int8_cache_stream_error"])
    if shape[1] == 1:
        assert err == ""  # DP-only: an int8 cache streams
    else:
        assert err.startswith("ValueError") and "not streamable" in err


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_ranks_that_part_raise(job, shape):
    err = str(job[f"{shape[0]}x{shape[1]}/disagree_error"])
    assert err.startswith("RuntimeError") and "different tokens" in err


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_logits_equal_single_device(setup, job, single, shape):
    """The sharded step's logits on the same tokens, every step, against the
    single-device step's: equal up to the order of the row-parallel sums."""
    want = decoding.teacher_forced_decode_logits(
        setup["params"], setup["const"], setup["mcfg"], setup["dcfg"],
        GenerateConfig(**_gcfg()), setup["batch"], torch.from_numpy(single)).numpy()
    got = job[f"{shape[0]}x{shape[1]}/tf_logits"]
    assert got.shape == want.shape == (B, LENGTH + 1, setup["mcfg"].gpt2.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def test_sharded_resolutions_pin_from_the_global_batch():
    """``auto`` pins from the global batch (int8 weights at B <= 32), and the
    cache resolves to the model dtype on any mesh; ``fused`` stays in scope on
    DP-only meshes and leaves it under TP."""
    auto = GenerateConfig(cache_dtype="auto", weight_dtype="auto")
    g = decoding._resolve_sharded_gcfg(auto, 64)
    assert (g.cache_dtype, g.weight_dtype) == ("model", "model")
    g = decoding._resolve_sharded_gcfg(auto, 32)
    assert (g.cache_dtype, g.weight_dtype) == ("model", "int8")
    fused = dataclasses.replace(GenerateConfig(), attn_impl="fused",
                                cache_dtype="int8", weight_dtype="model")
    assert decoding.resolve_attn_impl(fused, 768, batch_size=64) == "fused"
    assert decoding.resolve_attn_impl(fused, 384, "model", batch_size=64) == "kernel"
    assert decoding.resolve_cache_dtype(auto, 64, sharded=True) == "model"
    assert decoding.resolve_cache_dtype(auto, 64) == "int8"
