"""The port's parameter bridge and seeded init vs the JAX package's tree."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmtg_tpu.models import gpt2 as jgpt2
from mmtg_tpu.models.mmtg import init_mmtg_params
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch.models import gpt2

torch.set_num_threads(2)


def _layout(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), np.dtype(x.dtype).name), tree)


def test_init_params_matches_jax_layout(tiny_model_cfg):
    """Seeded torch init: the JAX tree's structure, shapes and dtypes, and
    a deterministic function of the seed."""
    got = tparams.to_numpy(tparams.init_params(tiny_model_cfg, seed=1))
    want = jax.eval_shape(lambda k: init_mmtg_params(k, tiny_model_cfg),
                          jax.random.PRNGKey(0))
    assert _layout(got) == _layout(want)
    again = tparams.to_numpy(tparams.init_params(tiny_model_cfg, seed=1))
    jax.tree.map(np.testing.assert_array_equal, got, again)
    other = tparams.to_numpy(tparams.init_params(tiny_model_cfg, seed=2))
    assert not np.array_equal(got["gpt2"]["wte"], other["gpt2"]["wte"])


def test_init_params_distributions(tiny_model_cfg):
    p = tparams.to_numpy(tparams.init_params(tiny_model_cfg, seed=0))
    g = tiny_model_cfg.gpt2
    w_hh = p["encoder"]["image"]["layers"][0]["w_hh"]  # orthogonal rows
    np.testing.assert_allclose(w_hh @ w_hh.T, np.eye(w_hh.shape[0]), atol=1e-5)
    assert abs(p["gpt2"]["wte"].std() - g.initializer_range) < 0.002
    bound = 1.0 / np.sqrt(tiny_model_cfg.mm_att_out_dim)
    assert np.abs(p["projector1"]["w"]).max() <= bound
    np.testing.assert_array_equal(p["gpt2"]["h"]["ln1_g"], 1.0)


def test_init_params_dtype_and_device(tiny_model_cfg):
    p = tparams.init_params(tiny_model_cfg, seed=0, dtype=torch.bfloat16)
    assert p["gpt2"]["h"]["attn_w"].dtype == torch.bfloat16
    assert p["gpt2"]["h"]["attn_w"].device.type == "cpu"


def test_bridge_roundtrip(tiny_model_cfg):
    """JAX pytree → torch → numpy is a copy, leaf for leaf (bf16 too)."""
    jparams = jax.tree.map(np.asarray, tparams.to_numpy(
        tparams.init_params(tiny_model_cfg, seed=3)))
    back = tparams.to_numpy(tparams.from_jax_numpy(jparams))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    x = jnp.asarray(np.linspace(-2, 2, 7), jnp.bfloat16)
    t = tparams.from_jax_numpy({"x": x})["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_quantize_decode_weights_matches_jax(tiny_model_cfg):
    tp = tparams.init_params(tiny_model_cfg, seed=4)["gpt2"]
    ref = jgpt2.quantize_decode_weights(
        jax.tree.map(jnp.asarray, tparams.to_numpy(tp)))
    got = gpt2.quantize_decode_weights(tp)
    for key in ("attn_w", "attn_proj_w", "mlp_fc_w", "mlp_proj_w"):
        np.testing.assert_array_equal(got["h"][key + "_q"].numpy(),
                                      np.asarray(ref["h"][key + "_q"]))
        np.testing.assert_array_equal(got["h"][key + "_s"].numpy(),
                                      np.asarray(ref["h"][key + "_s"]))
    np.testing.assert_array_equal(got["wte_q"].numpy(), np.asarray(ref["wte_q"]))
    np.testing.assert_array_equal(got["wte_s"].numpy(), np.asarray(ref["wte_s"]))
