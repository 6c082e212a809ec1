"""The port's recurrent cells (GRU, LSTM, RNN(relu)) vs
``mmtg_tpu.ops.rnn`` in f32 on the CPU: outputs and finals <= 1e-5, the
gradients of a scalar loss <= 1e-5 relative to each leaf's largest entry,
and the seeded init's shapes and layer-0 orthogonality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops import rnn as jrnn
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch.ops import rnn

from _torch_parity import leaf_close

T, B, IN, H = 5, 3, 12, 8
KINDS = ("GRU", "LSTM", "RNN")


def _inputs(kind, layers, seed=0):
    rng = np.random.default_rng(seed)
    G = rnn.GATES[kind] * H
    tree = {"layers": [
        {"w_ih": 0.4 * rng.standard_normal((IN if l == 0 else H, G)),
         "w_hh": 0.4 * rng.standard_normal((H, G)),
         "b_ih": 0.1 * rng.standard_normal(G),
         "b_hh": 0.1 * rng.standard_normal(G)} for l in range(layers)]}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    x = rng.standard_normal((T, B, IN)).astype(np.float32)
    return tree, x


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_rnn_forward_matches_jax(kind, layers):
    tree, x = _inputs(kind, layers)
    ref_out, ref_fin = jrnn.rnn_forward(jax.tree.map(jnp.asarray, tree),
                                        jnp.asarray(x), kind)
    out, fin = rnn.rnn_forward(tparams.from_jax_numpy(tree), torch.from_numpy(x), kind)
    assert out.shape == (T, B, H) and fin.shape == (layers, B, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(fin.numpy(), np.asarray(ref_fin), atol=1e-5, rtol=0)
    # the finals are the last step's h (for an LSTM: h, not c)
    np.testing.assert_array_equal(fin[-1].numpy(), out[-1].numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_rnn_gradients_match_jax(kind):
    """d/d(params, x) of sum(out * u) + sum(finals * v), two layers."""
    tree, x = _inputs(kind, 2, seed=1)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((T, B, H)).astype(np.float32)
    v = rng.standard_normal((2, B, H)).astype(np.float32)

    def jloss(p, xx):
        out, fin = jrnn.rnn_forward(p, xx, kind)
        return jnp.sum(out * u) + jnp.sum(fin * v)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tp = tparams.tree_map(lambda t: t.requires_grad_(True), tparams.from_jax_numpy(tree))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, fin = rnn.rnn_forward(tp, tx, kind)
    loss = (out * torch.from_numpy(u)).sum() + (fin * torch.from_numpy(v)).sum()
    leaves = tparams.tree_leaves(tp) + [tx]
    grads = torch.autograd.grad(loss, leaves)
    refs = tparams.tree_leaves(tparams.from_jax_numpy(jg_p)) + [torch.from_numpy(np.array(jg_x))]
    assert len(grads) == len(refs) == 9
    for g, r in zip(grads, refs):
        leaf_close(g.numpy(), r.numpy(), 1e-5)


def test_rnn_forward_rejects_an_unknown_kind():
    tree, x = _inputs("GRU", 1)
    with pytest.raises(ValueError, match="unknown rnn kind"):
        rnn.rnn_forward(tparams.from_jax_numpy(tree), torch.from_numpy(x), "TRM")


@pytest.mark.parametrize("kind", KINDS)
def test_init_shapes_and_layer0_orthogonality(kind):
    """The seeded init draws the JAX initializer's shapes; layer 0's w_hh,
    taken back to torch's [gates*H, H], has orthonormal columns; the
    U(-1/sqrt(H), 1/sqrt(H)) draws (biases, layer 1's w_hh) keep their
    bound."""
    ref = jax.jit(jrnn.init_rnn_params, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(0), kind, IN, H, 2)
    got = tparams._Init(0).rnn(kind, IN, H, 2)
    shapes = lambda t: [tuple(np.shape(a)) for a in tparams.tree_leaves(t)]  # noqa: E731
    assert shapes(got) == shapes(ref)
    w_hh = got["layers"][0]["w_hh"]  # [H, G*H]: columns of torch's [G*H, H]
    np.testing.assert_allclose((w_hh @ w_hh.T).numpy(), np.eye(H), atol=1e-5)
    bound = 1.0 / np.sqrt(H)
    for layer in got["layers"]:
        for k in ("b_ih", "b_hh"):
            assert float(layer[k].abs().max()) <= bound
    assert float(got["layers"][1]["w_hh"].abs().max()) <= bound
