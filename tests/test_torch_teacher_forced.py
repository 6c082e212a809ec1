"""The port's teacher-forced cached decode vs the JAX engine on the
conftest tiny config (f32, CPU): the parity surface of one cached step per
target token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import decoding as jdec
from mmtg_tpu.configs import GenerateConfig
from mmtg_tpu_torch import decoding

from _torch_parity import make_setup

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    return make_setup(tiny_model_cfg, tiny_data_cfg, tokenizer, jax_init=False)


@pytest.mark.parametrize("cache_dtype,atol", [("model", 1e-5), ("int8", 1e-4)])
def test_teacher_forced_logits_match_jax(setup, cache_dtype, atol):
    gcfg = GenerateConfig(cache_dtype=cache_dtype)
    # 24 tokens: past the first 22-token frame (a forced [#EOS#] / [#START#])
    tokens = setup["targets"][:, :24].astype(np.int32)
    # one compiled program: op by op, every cached step would recompile
    ref = jax.jit(jdec.teacher_forced_decode_logits,
                  static_argnums=(2, 3, 4))(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["jbatch"], jnp.asarray(tokens))
    got = decoding.teacher_forced_decode_logits(
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["tbatch"], torch.from_numpy(tokens))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0)
