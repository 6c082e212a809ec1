"""The selective remat policies of the port's train step
(``mmtg_tpu_torch.models.gpt2.REMAT_POLICIES``) against the JAX package's,
f32 on the CPU at the train slice's tiny model (2 layers): each policy's
loss and every gradient leaf equal JAX's under the same policy (remat live:
``deterministic=False`` with every dropout rate 0), unpacked and packed; with
dropout on, each policy equals the port's own step without remat; ``auto``
resolves as the JAX trainer's rule does; and what each policy runs again in
the backward, counted as calls of the plain attention function."""

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
from mmtg_tpu_torch.models import gpt2 as tgpt2
from mmtg_tpu_torch.params import tree_leaves

from _torch_parity import (
    leaf_close,
    make_packed_setup,
    make_train_setup,
    no_dropout,
    to_port_config,
)

torch.set_num_threads(2)
POLICIES = ("full", "save_qkv_ctx", "save_ctx_fc1", "save_all")
STAGE = 3


@pytest.fixture(scope="module")
def unpacked(tokenizer):
    return make_train_setup(tokenizer, n=4, ratings=[5.0, 1.0, 4.0, 3.0])


@pytest.fixture(scope="module")
def packed():
    rng = np.random.default_rng(1)
    lens = [[int(rng.integers(2, 14)) for _ in range(10)] for _ in range(9)]
    s = make_packed_setup(lens, row_len=256, max_slots=3, rows=4,
                          ratings=[5, 1, 4, 3, 2, 5, 3, 1, 4])
    s["tbatch"], s["jbatch"] = s["tpacked"], s["jpacked"]
    return s


def _setup(request, kind):
    return request.getfixturevalue(kind)


def _port_step(s, mcfg, policy, remat=True, impl="plain", seed=0):
    """The port's loss and gradient leaves, dropout generator on (remat is
    live only then)."""
    tt = dataclasses.replace(
        to_port_config(TrainConfig(alpha=0.2, dtype="float32", remat=remat,
                                   remat_policy=policy)), attn_impl=impl)
    params = tparams.tree_map(lambda x: x.clone().requires_grad_(True), s["tparams"])
    total, m = ttrain.loss_and_metrics(
        params, s["tconst"], mcfg, s["tdcfg"], tt, s["tbatch"], STAGE,
        torch.Generator().manual_seed(seed), False)
    grads = torch.autograd.grad(total, tree_leaves(params), allow_unused=True)
    leaves = tree_leaves(params)
    return float(total.detach()), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
@pytest.mark.parametrize("policy", POLICIES + ("auto",))
def test_policy_loss_and_gradients_equal_jax_under_the_same_policy(request, kind,
                                                                   policy):
    s = _setup(request, kind)
    jmcfg = no_dropout(s["mcfg"])
    jt = TrainConfig(alpha=0.2, dtype="float32", remat=True, remat_policy=policy,
                     attn_impl="xla")

    def jf(p):
        return jtrain.loss_and_metrics(p, s["jconst"], jmcfg, s["dcfg"], jt,
                                       s["jbatch"], jnp.asarray(STAGE),
                                       jax.random.PRNGKey(0), False)

    (ref_total, _), ref_g = jax.jit(jax.value_and_grad(jf, has_aux=True))(s["jparams"])
    total, grads = _port_step(s, to_port_config(jmcfg), policy)
    assert total == pytest.approx(float(ref_total), abs=1e-5)
    ref_leaves = jax.tree.leaves(ref_g)
    assert len(grads) == len(ref_leaves)
    for g, r in zip(grads, ref_leaves):
        leaf_close(g.numpy(), r, 1e-5)


@pytest.mark.parametrize("kind,impl", [("unpacked", "kernel"),
                                       ("unpacked", "kernel_padded"),
                                       ("unpacked", "plain"),
                                       ("packed", "kernel")])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_with_dropout_equals_no_remat(request, kind, impl, policy):
    """Dropout on at the model's rates: the masks are functions of seeds drawn
    before the layer loop, so the replay draws them again."""
    s = _setup(request, kind)
    assert s["tmcfg"].gpt2.attn_pdrop > 0 and s["tmcfg"].gpt2.resid_pdrop > 0
    ref_total, ref = _port_step(s, s["tmcfg"], "full", remat=False, impl=impl)
    total, grads = _port_step(s, s["tmcfg"], policy, impl=impl)
    largest = max(float(r.abs().max()) for r in ref)
    assert abs(total - ref_total) <= 1e-6 * abs(ref_total)
    for g, r in zip(grads, ref):
        assert float((g - r).abs().max()) <= 1e-6 * largest


def _counting(monkeypatch, name):
    calls = []
    real = getattr(tgpt2, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tgpt2, name, counted)
    return calls


@pytest.mark.parametrize("kind,plain", [("unpacked", "mha_train_packed_plain"),
                                        ("packed", "mha_train_packed_seg_plain")])
@pytest.mark.parametrize("policy,remat", [(p, True) for p in POLICIES]
                         + [("full", False)])
def test_attention_runs_again_only_under_full(request, monkeypatch, kind, plain,
                                              policy, remat):
    """One forward + backward: the plain attention function runs once a layer,
    and once more in the backward only when the policy keeps no context."""
    s = _setup(request, kind)
    calls = _counting(monkeypatch, plain)
    _port_step(s, s["tmcfg"], policy, remat=remat)
    L = s["tmcfg"].gpt2.n_layer
    assert len(calls) == (2 * L if remat and policy == "full" else L)


def test_unknown_policy_raises(unpacked):
    with pytest.raises(ValueError, match="remat_policy"):
        _port_step(unpacked, unpacked["tmcfg"], "save_everything")


def _shape_batch(kind, B, T):
    key = "tokens" if kind == "packed" else "targets"
    return {key: np.zeros((B, T), np.int32)}


# (kind, global rows, length): both sides of the 5e9 gate, the 128 pad
# boundary of the prompt + targets (113 + 15 = 128, 114 + 15 = 129), and the
# full-width defaults (B = 64, 256, 512 x 221 targets; 32 rows of 512)
SHAPES = [("unpacked", 64, 221), ("unpacked", 256, 221), ("unpacked", 512, 221),
          ("unpacked", 264, 221), ("unpacked", 265, 221), ("unpacked", 8, 113),
          ("unpacked", 400, 113), ("unpacked", 400, 114), ("packed", 32, 512),
          ("packed", 132, 512), ("packed", 133, 512), ("packed", 16, 1024)]


@pytest.mark.parametrize("policy", ("auto",) + POLICIES)
@pytest.mark.parametrize("kind,B,T", SHAPES)
def test_resolve_remat_policy_equals_jax(kind, B, T, policy):
    batch = _shape_batch(kind, B, T)
    want = jtrain._resolve_remat_policy(policy, batch)
    assert ttrain._resolve_remat_policy(policy, batch) == want
    # this rank's rows of a data axis of 4: JAX's step sees the global batch
    if B % 4 == 0:
        local = _shape_batch(kind, B // 4, T)
        assert ttrain._resolve_remat_policy(policy, local, data_size=4) == want
    assert ttrain._resolve_remat_policy(policy, batch, pp=("mesh", 2)) == \
        jtrain._resolve_remat_policy(policy, batch, pp=("mesh", 2))


def test_resolve_remat_policy_at_the_full_width_defaults():
    got = {(k, B, T): ttrain._resolve_remat_policy("auto", _shape_batch(k, B, T))
           for k, B, T in SHAPES[:3] + [SHAPES[8]]}
    assert got == {("unpacked", 64, 221): "save_qkv_ctx",
                   ("unpacked", 256, 221): "save_qkv_ctx",
                   ("unpacked", 512, 221): "full",
                   ("packed", 32, 512): "save_qkv_ctx"}
    assert ttrain._resolve_remat_policy("auto") == jtrain._resolve_remat_policy("auto")
    assert ttrain._resolve_remat_policy("auto") == "full"
    # the topic prompt's length is the data config's, not a literal 15
    assert ttrain._resolve_remat_policy(
        "auto", _shape_batch("unpacked", 400, 113), prompt_len=16) == "full"


@pytest.mark.parametrize("accum", [1, 2])
def test_auto_resolves_on_the_micro_batch_that_reaches_the_loss(unpacked,
                                                                monkeypatch, accum):
    seen = []
    real = ttrain._resolve_remat_policy

    def spy(policy, batch=None, *a, **k):
        seen.append((batch["targets"].shape[0], a, k))
        return real(policy, batch, *a, **k)

    monkeypatch.setattr(ttrain, "_resolve_remat_policy", spy)
    tt = dataclasses.replace(
        to_port_config(TrainConfig(alpha=0.2, dtype="float32", grad_accum=accum)),
        attn_impl="plain")
    state, tx = ttrain.create_train_state(0, unpacked["tmcfg"], tt, 2, 10,
                                          unpacked["tparams"], device="cpu")
    ttrain.make_train_step(unpacked["tmcfg"], unpacked["tdcfg"], tt, tx)(
        state, unpacked["tconst"], unpacked["tbatch"], STAGE)
    assert [b for b, _, _ in seen] == [4 // accum] * accum
    assert all(a[-1] == 1 for _, a, _ in seen)  # data_size of one device
