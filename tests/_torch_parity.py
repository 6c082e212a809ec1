"""Shared inputs for the port-vs-JAX parity tests on the conftest tiny
config: one JAX parameter tree (``init_mmtg_params``) handed to the port
through ``params.from_jax_numpy``, and one batch made from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmtg_tpu.data import MMTGDataset, make_synthetic_records
from mmtg_tpu.models.mmtg import init_mmtg_params
from mmtg_tpu_torch import params as tparams

BATCH_KEYS = ("topic_ids", "tpw_attention_mask", "tpw_type_ids", "topic_emb",
              "img_embs", "r_embs")


def make_setup(mcfg, dcfg, tokenizer, seed=7, jax_init=True):
    """``jax_init=False`` takes the port's seeded init instead of JAX's (the
    same tree, without compiling the JAX initializer)."""
    rng = np.random.default_rng(seed)
    records = make_synthetic_records(2, rng, emb_size=dcfg.wenlan_emb_size)
    ds = MMTGDataset.from_records(records, tokenizer, dcfg, if_train=False)
    batch = next(ds.batches(batch_size=2))
    V = mcfg.gpt2.vocab_size
    for k in ("topic_ids", "targets"):
        batch[k] = np.minimum(batch[k], V - 1)
    np_batch = {k: batch[k] for k in BATCH_KEYS}
    if jax_init:
        # jitted: op by op, the init's many small random draws each compile
        jparams = jax.jit(init_mmtg_params, static_argnums=1)(
            jax.random.PRNGKey(3), mcfg)
    else:
        jparams = jax.tree.map(jnp.asarray, tparams.to_numpy(
            tparams.init_params(mcfg, seed=3)))
    table = rng.standard_normal((V, dcfg.wenlan_emb_size)).astype(np.float32)
    return dict(
        mcfg=mcfg, dcfg=dcfg, targets=batch["targets"],
        jparams=jparams, jconst={"wenlan_table": jnp.asarray(table)},
        jbatch={k: jnp.asarray(v) for k, v in np_batch.items()},
        tparams=tparams.from_jax_numpy(jparams),
        tconst={"wenlan_table": torch.from_numpy(table)},
        tbatch={k: torch.from_numpy(v) for k, v in np_batch.items()},
    )
