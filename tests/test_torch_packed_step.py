"""The packed train step as a whole vs the JAX package, f32 on the CPU, same
parameters and the same packed batch: loss_and_metrics value and every
gradient leaf, three optimizer steps, the PAD-free equivalence with the
parity loss, and grad_accum over packed rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import train as jtrain
from mmtg_tpu.configs import TrainConfig
from mmtg_tpu_torch import pack as tpack
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch import train as ttrain
from mmtg_tpu_torch.params import tree_leaves

from _torch_parity import leaf_close, make_packed_setup, to_port_config

torch.set_num_threads(2)
WARMUP, TOTAL = 2, 10


def _no_dropout(mcfg):
    return dataclasses.replace(
        mcfg, dropout=0.0,
        gpt2=dataclasses.replace(mcfg.gpt2, resid_pdrop=0.0, embd_pdrop=0.0,
                                 attn_pdrop=0.0))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    lens = [[int(rng.integers(2, 14)) for _ in range(10)] for _ in range(9)]
    s = make_packed_setup(lens, row_len=256, max_slots=3, rows=4,
                          ratings=[5, 1, 4, 3, 2, 5, 3, 1, 4])
    s["mcfg"] = _no_dropout(s["mcfg"])
    s["tmcfg"] = to_port_config(s["mcfg"])
    return s


def _tcfgs(**kw):
    base = dict(alpha=0.2, dtype="float32", lr=1e-4, remat=False, attn_impl="xla")
    base.update(kw)
    jt = TrainConfig(**base)
    return jt, dataclasses.replace(to_port_config(jt), attn_impl="kernel")




@pytest.mark.parametrize("loss_impl", ["full", "chunked"])
@pytest.mark.parametrize("stage", [1, 3])
def test_packed_loss_and_every_gradient_leaf_match_jax(setup, stage, loss_impl):
    jt, tt = _tcfgs(loss_impl=loss_impl)

    def jf(p):
        return jtrain.loss_and_metrics(p, setup["jconst"], setup["mcfg"],
                                       setup["dcfg"], jt, setup["jpacked"],
                                       jnp.asarray(stage), None, True)

    (ref_total, ref_m), ref_g = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        setup["jparams"])
    params = tparams.tree_map(lambda x: x.clone().requires_grad_(True),
                              setup["tparams"])
    total, m = ttrain.loss_and_metrics(params, setup["tconst"], setup["tmcfg"],
                                       setup["tdcfg"], tt, setup["tpacked"], stage,
                                       None, True)
    for k in ("loss", "kl", "total", "kept"):
        assert float(m[k]) == pytest.approx(float(ref_m[k]), abs=1e-5), k
    assert float(total.detach()) == pytest.approx(float(ref_total), abs=1e-5)
    assert 0 < float(m["kept"]) <= float(setup["np_packed"]["slot_valid"].sum())
    grads = torch.autograd.grad(total, tree_leaves(params), allow_unused=True)
    ref_leaves = jax.tree.leaves(ref_g)
    assert len(grads) == len(ref_leaves)
    for g, r in zip(grads, ref_leaves):
        g = np.zeros(r.shape, np.float32) if g is None else g.numpy()
        leaf_close(g, r, 1e-5)


def test_three_packed_train_steps_match_jax(setup):
    jt, tt = _tcfgs()
    jstate, jtx = jtrain.create_train_state(jax.random.PRNGKey(0), setup["mcfg"], jt,
                                            WARMUP, TOTAL, params=setup["jparams"])
    jstep = jtrain.make_train_step(setup["mcfg"], setup["dcfg"], jt, jtx)
    state, tx = ttrain.create_train_state(0, setup["tmcfg"], tt, WARMUP, TOTAL,
                                          setup["tparams"], device="cpu")
    step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], tt, tx)
    for i in range(3):
        # the JAX step donates its input: hand it a copy
        jstate, jm = jstep(jax.tree.map(jnp.array, jstate), setup["jconst"],
                           setup["jpacked"], jnp.asarray(3))
        state, m = step(state, setup["tconst"], setup["tpacked"], 3)
        assert state.step == i + 1 and int(state.opt_state["count"]) == i + 1
        for k in ("loss", "kl", "total", "kept"):
            assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-5)
        for got, ref in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
            assert float(np.abs(got.detach().numpy() - np.asarray(ref)).max()) <= 1e-6


def test_padfree_sample_gives_the_parity_loss_and_gradients():
    """Zero PAD: the packed rows are the 236-token parity rows, the label
    count is 220, and the two objectives coincide."""
    s = make_packed_setup([[20] * 10 for _ in range(4)], row_len=236, max_slots=1,
                          rows=4, seed=2)
    mcfg = to_port_config(_no_dropout(s["mcfg"]))
    _, tt = _tcfgs(loss_impl="full")
    np.testing.assert_array_equal(s["np_packed"]["slot_nlabels"], 220.0)
    assert s["np_packed"]["slot_valid"].sum() == 4
    parity = dict(s["tcols"], sample_mask=torch.ones(4))
    out = []
    for batch in (parity, s["tpacked"]):
        params = tparams.tree_map(lambda x: x.clone().requires_grad_(True),
                                  s["tparams"])
        total, m = ttrain.loss_and_metrics(params, s["tconst"], mcfg, s["tdcfg"],
                                           tt, batch, 3, None, True)
        out.append((float(total.detach()), float(m["kept"]),
                    torch.autograd.grad(total, tree_leaves(params), allow_unused=True)))
    assert out[0][0] == pytest.approx(out[1][0], rel=2e-5)
    assert out[0][1] == out[1][1] == 4.0
    for a, b in zip(out[0][2], out[1][2]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("stage", [1, 3])
def test_grad_accum_over_packed_rows_equals_one_chunk(setup, stage):
    _, tt = _tcfgs()
    results = []
    for accum in (1, 2, 4):
        cfg = dataclasses.replace(tt, grad_accum=accum)
        state, tx = ttrain.create_train_state(0, setup["tmcfg"], cfg, WARMUP, TOTAL,
                                              setup["tparams"], device="cpu")
        step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], cfg, tx)
        metrics = []
        for _ in range(2):  # the second step moves the parameters
            state, m = step(state, setup["tconst"], setup["tpacked"], stage)
            metrics.append({k: float(v) for k, v in m.items()})
        results.append((state, metrics))
    for s2, m2 in results[1:]:
        for a, b in zip(results[0][1], m2):
            for k in a:
                assert a[k] == pytest.approx(b[k], abs=1e-5), k
        for a, b in zip(tree_leaves(results[0][0].params), tree_leaves(s2.params)):
            assert float((a - b).detach().abs().max()) <= 1e-6


def test_packed_step_with_dropout_remat_and_bf16_runs_and_descends(setup):
    mcfg = to_port_config(dataclasses.replace(
        setup["mcfg"], dropout=0.1,
        gpt2=dataclasses.replace(setup["mcfg"].gpt2, resid_pdrop=0.1, embd_pdrop=0.1,
                                 attn_pdrop=0.1)))
    _, tt = _tcfgs(dtype="bfloat16", remat=True, lr=1e-3)
    state, tx = ttrain.create_train_state(0, mcfg, tt, 1, 20, setup["tparams"],
                                          device="cpu")
    step = ttrain.make_train_step(mcfg, setup["tdcfg"], tt, tx)
    totals = []
    for _ in range(5):
        state, m = step(state, setup["tconst"], setup["tpacked"], 3)
        totals.append(float(m["total"]))
    assert all(np.isfinite(totals)) and totals[-1] < totals[0]
    assert all(p.dtype == torch.float32 for p in tree_leaves(state.params))
    assert float(m["kept"]) == float(setup["np_packed"]["slot_valid"].sum())


def test_loss_impl_auto_reads_the_packed_shape():
    small = {"tokens": torch.zeros(4, 256, dtype=torch.int32)}
    assert ttrain._resolve_loss_impl("auto", small, 200) == "full"
    big = {"tokens": torch.zeros(128, 512, dtype=torch.int32)}
    assert ttrain._resolve_loss_impl("auto", big, 13317) == "chunked"
    assert ttrain._resolve_loss_impl("full", big, 13317) == "full"


def test_the_port_packer_feeds_the_step(setup):
    """The port's own PackedBatcher on the same columns yields the batch the
    JAX package's yields (what the CLI hands to the step)."""
    pb = tpack.PackedBatcher(setup["cols"], setup["tdcfg"], row_len=256, max_slots=3)
    mine = next(pb.batches(4))
    for k, v in setup["np_packed"].items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
