"""The train slice as a whole vs the JAX package, f32 on the CPU, same
parameters and the same synthetic batch: loss_and_metrics value and every
gradient leaf, three optimizer steps (the rate-0 first step and the warmup
included), grad_accum 1 = 2, and the zero-kept no-op."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import train as jtrain
from mmtg_tpu.configs import TrainConfig
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch import train as ttrain
from mmtg_tpu_torch.params import tree_leaves

from _torch_parity import make_train_setup, to_port_config

torch.set_num_threads(2)
WARMUP, TOTAL = 2, 10


def _no_dropout(mcfg):
    return dataclasses.replace(
        mcfg, dropout=0.0,
        gpt2=dataclasses.replace(mcfg.gpt2, resid_pdrop=0.0, embd_pdrop=0.0,
                                 attn_pdrop=0.0))


@pytest.fixture(scope="module")
def setup(tokenizer):
    s = make_train_setup(tokenizer, n=4, ratings=[5.0, 1.0, 4.0, 3.0])
    s["mcfg"] = _no_dropout(s["mcfg"])
    s["tmcfg"] = to_port_config(s["mcfg"])
    return s


def _tcfgs(**kw):
    base = dict(alpha=0.2, dtype="float32", lr=1e-4, remat=False, attn_impl="xla")
    base.update(kw)
    jt = TrainConfig(**base)
    return jt, dataclasses.replace(to_port_config(jt), attn_impl="kernel")


def _leaf_close(got, ref, tol):
    """max-abs <= tol relative to the reference leaf's max. A leaf whose
    gradient is zero in exact arithmetic (a key bias under a softmax) holds
    rounding noise of order 1e-9 on both sides: hence the 1e-7 floor."""
    ref = np.asarray(ref)
    assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max()) + 1e-7


@pytest.mark.parametrize("loss_impl", ["full", "chunked"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_loss_and_every_gradient_leaf_match_jax(setup, stage, loss_impl):
    jt, tt = _tcfgs(loss_impl=loss_impl)

    def jf(p):
        return jtrain.loss_and_metrics(p, setup["jconst"], setup["mcfg"],
                                       setup["dcfg"], jt, setup["jbatch"],
                                       jnp.asarray(stage), None, True)

    (ref_total, ref_m), ref_g = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        setup["jparams"])
    params = tparams.tree_map(lambda x: x.clone().requires_grad_(True),
                              setup["tparams"])
    total, m = ttrain.loss_and_metrics(params, setup["tconst"], setup["tmcfg"],
                                       setup["tdcfg"], tt, setup["tbatch"], stage,
                                       None, True)
    for k in ("loss", "kl", "total", "kept"):
        assert float(m[k]) == pytest.approx(float(ref_m[k]), abs=1e-5), k
    assert float(total.detach()) == pytest.approx(float(ref_total), abs=1e-5)
    grads = torch.autograd.grad(total, tree_leaves(params), allow_unused=True)
    ref_leaves = jax.tree.leaves(ref_g)
    assert len(grads) == len(ref_leaves)
    for g, r in zip(grads, ref_leaves):
        g = np.zeros(r.shape, np.float32) if g is None else g.numpy()
        _leaf_close(g, r, 1e-5)


def _jax_steps(setup, jt, n, stage=3, batch=None):
    state, tx = jtrain.create_train_state(jax.random.PRNGKey(0), setup["mcfg"], jt,
                                          WARMUP, TOTAL, params=setup["jparams"])
    step = jtrain.make_train_step(setup["mcfg"], setup["dcfg"], jt, tx)
    states, metrics = [], []
    for _ in range(n):
        # the step donates its input: hand it a copy, keep ours
        state, m = step(jax.tree.map(jnp.array, state), setup["jconst"],
                        batch or setup["jbatch"], jnp.asarray(stage))
        states.append(state)
        metrics.append(m)
    return states, metrics


def _torch_state(setup, tt, params=None):
    return ttrain.create_train_state(0, setup["tmcfg"], tt, WARMUP, TOTAL,
                                     params or setup["tparams"], device="cpu")


def _params_close(tstate, jstate, tol=1e-6):
    for got, ref in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
        assert float(np.abs(got.detach().numpy() - np.asarray(ref)).max()) <= tol


def test_three_train_steps_match_jax(setup):
    jt, tt = _tcfgs()
    jstates, jmetrics = _jax_steps(setup, jt, 3)
    state, tx = _torch_state(setup, tt)
    start = [p.detach().clone() for p in tree_leaves(state.params)]
    step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], tt, tx)
    for i in range(3):
        state, m = step(state, setup["tconst"], setup["tbatch"], 3)
        assert state.step == i + 1 and int(state.opt_state["count"]) == i + 1
        for k in ("loss", "kl", "total", "kept"):
            assert float(m[k]) == pytest.approx(float(jmetrics[i][k]), abs=1e-5)
        _params_close(state, jstates[i])
        moved = max(float((p.detach() - s).abs().max())
                    for p, s in zip(tree_leaves(state.params), start))
        # the schedule is read at the count before the update: rate 0 first
        assert (moved == 0.0) if i == 0 else (moved > 1e-6)


def test_adam_state_bridge_continues_a_jax_run(setup):
    """Two JAX steps, then the state (params, mu, nu, count) crosses the
    bridge and the port's third step equals JAX's third step."""
    jt, tt = _tcfgs()
    jstates, _ = _jax_steps(setup, jt, 3)
    adam = jstates[1].opt_state[1][0]  # chain(clip, chain(adam, decay, schedule))
    state, tx = _torch_state(setup, tt, tparams.from_jax_numpy(jstates[1].params))
    bridged = tparams.adam_state_from_numpy(adam.mu, adam.nu, adam.count)
    assert int(bridged["count"]) == 2
    state = state._replace(opt_state=bridged, step=2)
    step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], tt, tx)
    state, _ = step(state, setup["tconst"], setup["tbatch"], 3)
    _params_close(state, jstates[2])
    mu, nu, count = tparams.adam_state_to_numpy(state.opt_state)
    adam3 = jstates[2].opt_state[1][0]
    assert count == int(adam3.count) == 3
    for got, ref in zip(jax.tree.leaves(mu), jax.tree.leaves(adam3.mu)):
        _leaf_close(got, ref, 1e-5)
    for got, ref in zip(jax.tree.leaves(nu), jax.tree.leaves(adam3.nu)):
        _leaf_close(got, ref, 1e-5)


@pytest.mark.parametrize("stage", [1, 3])
def test_grad_accum_two_equals_one(setup, stage):
    _, tt = _tcfgs()
    results = []
    for accum in (1, 2):
        cfg = dataclasses.replace(tt, grad_accum=accum)
        state, tx = _torch_state(setup, cfg)
        step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], cfg, tx)
        metrics = []
        for _ in range(2):  # the second step moves the parameters
            state, m = step(state, setup["tconst"], setup["tbatch"], stage)
            metrics.append({k: float(v) for k, v in m.items()})
        results.append((state, metrics))
    (s1, m1), (s2, m2) = results
    for a, b in zip(m1, m2):
        for k in a:
            assert a[k] == pytest.approx(b[k], abs=1e-5), k
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert float((a - b).detach().abs().max()) <= 1e-6


def test_grad_accum_rejects_indivisible_batch(setup):
    _, tt = _tcfgs(grad_accum=3)
    state, tx = _torch_state(setup, tt)
    step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], tt, tx)
    with pytest.raises(ValueError):
        step(state, setup["tconst"], setup["tbatch"], 3)


def test_zero_kept_batch_changes_nothing_but_step(setup):
    _, tt = _tcfgs()
    state, tx = _torch_state(setup, tt)
    step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], tt, tx)
    for _ in range(2):  # non-zero moments first
        state, _ = step(state, setup["tconst"], setup["tbatch"], 3)
    before = [t.detach().clone() for t in tree_leaves(state.params)
              + tree_leaves(state.opt_state)]
    batch = dict(setup["tbatch"])
    batch["rating"] = torch.full_like(batch["rating"], 3.0)  # stage 1 keeps none
    state, m = step(state, setup["tconst"], batch, 1)
    assert float(m["kept"]) == 0.0
    assert state.step == 3 and int(state.opt_state["count"]) == 2
    after = tree_leaves(state.params) + tree_leaves(state.opt_state)
    for a, b in zip(before, after):
        assert torch.equal(a, b.detach())


def test_schedule_matches_optax():
    jt, tt = _tcfgs()
    ref = jtrain.make_schedule(jt, WARMUP, TOTAL)
    got = ttrain.make_schedule(tt, WARMUP, TOTAL)
    for count in range(TOTAL + 3):
        assert float(got(count)) == pytest.approx(float(ref(count)), abs=1e-10)
    assert float(got(0)) == 0.0 and float(got(WARMUP)) == pytest.approx(jt.lr)


def test_bf16_compute_keeps_f32_masters(setup):
    _, tt = _tcfgs(dtype="bfloat16", remat=True)
    state, tx = _torch_state(setup, tt)
    step = ttrain.make_train_step(setup["tmcfg"], setup["tdcfg"], tt, tx)
    for _ in range(2):
        state, m = step(state, setup["tconst"], setup["tbatch"], 3)
    assert all(p.dtype == torch.float32 for p in tree_leaves(state.params))
    assert all(p.dtype == torch.float32 for p in tree_leaves(state.opt_state["mu"]))
    assert np.isfinite(float(m["total"]))
    f32_total, _ = ttrain.loss_and_metrics(
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"],
        dataclasses.replace(tt, dtype="float32"), setup["tbatch"], 3, None, True)
    bf_total, _ = ttrain.loss_and_metrics(
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"], tt,
        setup["tbatch"], 3, None, True)
    assert float(bf_total) == pytest.approx(float(f32_total), rel=3e-2)


def test_unported_remat_policy_raises(setup):
    _, tt = _tcfgs(remat_policy="save_qkv_ctx")
    with pytest.raises(NotImplementedError):
        ttrain.loss_and_metrics(setup["tparams"], setup["tconst"], setup["tmcfg"],
                                setup["tdcfg"], tt, setup["tbatch"], 3, None, True)
