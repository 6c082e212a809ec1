"""Shared inputs for the port-vs-JAX parity tests on the conftest tiny
config: one JAX parameter tree (``init_mmtg_params``) handed to the port
through ``params.from_jax_numpy``, and one batch made from a seed (a parity
batch, or a packed one from ``PackedBatcher.batches``)."""

import subprocess
import sys

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


def stop_torchrun(proc, grace_s: float = 60.0) -> None:
    """End a ``torchrun`` started with ``subprocess.Popen`` and its ranks.
    SIGTERM first: the launcher starts each rank in a session of its own and
    stops them itself on SIGTERM, while a SIGKILL to it would orphan them."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(grace_s)


def run_torchrun(nproc: int, args, timeout: float, **kw):
    """``python -m torch.distributed.run --standalone`` of ``args`` with
    ``nproc`` ranks and a time limit; the output captured. On the limit the
    launcher and its ranks are stopped (:func:`stop_torchrun`) and
    ``subprocess.TimeoutExpired`` raises."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_torchrun(proc)
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def to_port_config(cfg):
    """A config dataclass of the JAX package → the port's class of the same
    name, field by field (nested configs converted too)."""
    import dataclasses

    from mmtg_tpu_torch import configs as tconfigs

    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(tconfigs, type(cfg).__name__)
    return cls(**{f.name: to_port_config(getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg)})


def train_configs():
    """The train-slice tiny model: 2 layers, 2 heads of 64 (the packed
    kernel's head width), n_embd 128, vocab 200, 64-d WenLan. Returns the
    JAX package's (mcfg, dcfg)."""
    from mmtg_tpu.configs import ChannelConfig, DataConfig, GPT2Config, ModelConfig

    mcfg = ModelConfig(
        seq_len=5,
        topic=ChannelConfig(input_dim=64, hidden_dim=32, type="MLP"),
        image=ChannelConfig(input_dim=64, hidden_dim=32, type="GRU"),
        text=ChannelConfig(input_dim=64, hidden_dim=32, type="GRU"),
        self_att_hidden_size=32, self_att_heads=4, mm_att_out_dim=64,
        gpt2=GPT2Config(vocab_size=200, n_positions=256, n_ctx=250, n_embd=128,
                        n_layer=2, n_head=2),
    )
    return mcfg, DataConfig(wenlan_emb_size=64)


def _params_and_table(mcfg, dcfg, rng):
    """The port's seeded init as a JAX tree, biases and LN gains moved off
    their init values (so their gradients matter), and a WenLan table."""
    jparams = jax.tree.map(jnp.asarray, tparams.to_numpy(
        tparams.init_params(to_port_config(mcfg), seed=3)))
    leaves, treedef = jax.tree.flatten(jparams)
    leaves = [x + 0.02 * rng.standard_normal(x.shape).astype(np.float32)
              for x in leaves]
    table = rng.standard_normal(
        (mcfg.gpt2.vocab_size, dcfg.wenlan_emb_size)).astype(np.float32)
    return jax.tree.unflatten(treedef, leaves), table


def make_train_setup(tokenizer, n=4, seed=11, ratings=None, mcfg=None):
    """One train batch (``make_synthetic_records`` through ``MMTGDataset``,
    ids folded into the tiny vocab) and one parameter tree, for both
    packages; ``mcfg`` (the JAX package's) replaces the train-slice model."""
    tiny, dcfg = train_configs()
    mcfg = mcfg or tiny
    rng = np.random.default_rng(seed)
    records = make_synthetic_records(n, rng, emb_size=dcfg.wenlan_emb_size)
    if ratings is not None:
        for r, v in zip(records, ratings):
            r["rating"] = v
    ds = MMTGDataset.from_records(records, tokenizer, dcfg, if_train=True)
    batch = next(ds.batches(batch_size=n))
    V = mcfg.gpt2.vocab_size
    for k in ("topic_ids", "targets"):
        batch[k] = np.minimum(batch[k], V - 1)
    jparams, table = _params_and_table(mcfg, dcfg, rng)
    return dict(
        mcfg=mcfg, dcfg=dcfg, tmcfg=to_port_config(mcfg),
        tdcfg=to_port_config(dcfg), np_batch=batch,
        jparams=jparams, jconst={"wenlan_table": jnp.asarray(table)},
        jbatch={k: jnp.asarray(v) for k, v in batch.items()},
        tparams=tparams.from_jax_numpy(jparams),
        tconst={"wenlan_table": torch.from_numpy(table)},
        tbatch={k: torch.from_numpy(v) for k, v in batch.items()},
    )


def leaf_close(got, ref, tol):
    """max-abs <= tol relative to the reference leaf's max. A leaf whose
    gradient is zero in exact arithmetic holds rounding noise of order 1e-9
    on both sides: hence the 1e-7 floor."""
    ref = np.asarray(ref)
    assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max()) + 1e-7


def packed_inputs(np_batch):
    """One packed batch (the numpy dict ``PackedBatcher.batches`` yields) as
    both sides' inputs: (jax dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in np_batch.items()})


def make_packed_setup(content_lens, row_len=256, max_slots=4, rows=4, seed=21,
                      ratings=None):
    """Synthetic framed columns with the given per-sentence content lengths
    (``synthetic_framed_cols`` of the JAX package, ids inside the tiny
    vocab), packed by the JAX package's ``PackedBatcher``; the train-slice
    tiny model and one parameter tree for both packages. ``np_packed`` is the
    first batch of ``rows`` rows."""
    from mmtg_tpu.pack import PackedBatcher, synthetic_framed_cols

    mcfg, dcfg = train_configs()
    rng = np.random.default_rng(seed)
    cols = synthetic_framed_cols(rng, dcfg, content_lens,
                                 emb_size=dcfg.wenlan_emb_size, n_windows=5,
                                 vocab_high=mcfg.gpt2.vocab_size - 10)
    if ratings is not None:
        cols["rating"] = np.asarray(ratings, np.float32)
    np_packed = next(PackedBatcher(cols, dcfg, row_len=row_len,
                                   max_slots=max_slots).batches(rows))
    jparams, table = _params_and_table(mcfg, dcfg, rng)
    jpacked, tpacked = packed_inputs(np_packed)
    return dict(
        mcfg=mcfg, dcfg=dcfg, tmcfg=to_port_config(mcfg),
        tdcfg=to_port_config(dcfg), cols=cols, np_packed=np_packed,
        jparams=jparams, jconst={"wenlan_table": jnp.asarray(table)},
        jpacked=jpacked, jcols={k: jnp.asarray(v) for k, v in cols.items()},
        tparams=tparams.from_jax_numpy(jparams),
        tconst={"wenlan_table": torch.from_numpy(table)},
        tpacked=tpacked, tcols={k: torch.from_numpy(v) for k, v in cols.items()},
    )
