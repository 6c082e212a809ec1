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


# ---------------------------------------------------------------------------
# The meshed train path: one tiny model whose 12 heads split 2, 3 and 4 ways
# ---------------------------------------------------------------------------
# the global batch's ratings: at stage 2 (rating 3 dropped) the rank rows keep
# 2, 1, 0, 2 at dp = 4 and 3, 2 at dp = 2
MESH_RATINGS = [5.0, 1.0, 3.0, 4.0, 3.0, 3.0, 2.0, 5.0]
MESH_STAGE, MESH_ZERO_STAGE = 2, 1
MESH_WARMUP, MESH_TOTAL = 2, 10


def mesh_model_cfg():
    """The train slice's tiny model with 2 layers, 12 heads of 8 and vocab 50
    (the JAX package's config)."""
    import dataclasses

    from mmtg_tpu.configs import GPT2Config

    mcfg, _ = train_configs()
    return dataclasses.replace(mcfg, gpt2=GPT2Config(
        vocab_size=50, n_positions=256, n_ctx=250, n_embd=96, n_layer=2, n_head=12))


def no_dropout(mcfg):
    import dataclasses

    return dataclasses.replace(
        mcfg, dropout=0.0,
        gpt2=dataclasses.replace(mcfg.gpt2, resid_pdrop=0.0, embd_pdrop=0.0,
                                 attn_pdrop=0.0))


def mesh_tcfgs():
    """(JAX TrainConfig, the port's): f32, lr 1e-4, alpha 0.2; the port
    recomputes blocks (the TP sums run under remat), JAX does not."""
    import dataclasses

    from mmtg_tpu.configs import TrainConfig

    jt = TrainConfig(alpha=0.2, dtype="float32", lr=1e-4, remat=False,
                     attn_impl="xla")
    return jt, dataclasses.replace(to_port_config(jt), attn_impl="kernel", remat=True)


def mesh_train_setup(tokenizer):
    """:func:`make_train_setup` of 8 rows on the mesh model (dropout off),
    plus ``zero_batch``, a batch that stage 1 keeps none of, and the model
    with its dropout (``mcfg_dropout``)."""
    mcfg = mesh_model_cfg()
    s = make_train_setup(tokenizer, n=8, ratings=MESH_RATINGS, mcfg=no_dropout(mcfg))
    s["mcfg_dropout"] = mcfg
    zero = {k: v.copy() for k, v in s["np_batch"].items()}
    zero["rating"][:] = 3.0
    s["zero_batch"] = zero
    return s


def mesh_job_inputs(s, path):
    """The job's inputs file: configs, parameters, batches (numpy)."""
    _, tt = mesh_tcfgs()
    torch.save(dict(
        mcfg=s["tmcfg"], dcfg=s["tdcfg"], tcfg=tt,
        mcfg_dropout=to_port_config(s["mcfg_dropout"]), tcfg_dropout=tt,
        params=s["tparams"], const=s["tconst"], batch=s["np_batch"],
        zero_batch=s["zero_batch"], warmup=MESH_WARMUP, total=MESH_TOTAL), path)


def jax_mesh_reference(s):
    """JAX's single-device metrics and gradients at the mesh stage, its eval
    metrics, and its state after two train steps (numpy leaves)."""
    from mmtg_tpu import train as jtrain

    jt, _ = mesh_tcfgs()

    def jf(p):
        return jtrain.loss_and_metrics(p, s["jconst"], s["mcfg"], s["dcfg"], jt,
                                       s["jbatch"], jnp.asarray(MESH_STAGE), None, True)

    (_, metrics), grads = jax.jit(jax.value_and_grad(jf, has_aux=True))(s["jparams"])
    eval_m = jtrain.make_eval_step(s["mcfg"], s["dcfg"], jt)(
        s["jparams"], s["jconst"], s["jbatch"], jnp.asarray(MESH_STAGE))
    state, tx = jtrain.create_train_state(jax.random.PRNGKey(0), s["mcfg"], jt,
                                          MESH_WARMUP, MESH_TOTAL, params=s["jparams"])
    step = jtrain.make_train_step(s["mcfg"], s["dcfg"], jt, tx)
    for _ in range(2):
        # the step donates its input: hand it a copy
        state, _ = step(jax.tree.map(jnp.array, state), s["jconst"], s["jbatch"],
                        jnp.asarray(MESH_STAGE))
    adam = state.opt_state[1][0]
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]  # noqa: E731
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                eval={k: float(v) for k, v in eval_m.items()},
                grads=leaves(grads), params=leaves(state.params), mu=leaves(adam.mu),
                nu=leaves(adam.nu), count=int(adam.count))


def npz_leaves(job, prefix):
    """The leaves a job wrote as ``<prefix>/<i>``, in order."""
    n = len([k for k in job if k.startswith(prefix + "/")])
    return [job[f"{prefix}/{i}"] for i in range(n)]


def run_mesh_job(script, inputs, out, timeout, nproc=4):
    """A gloo job of ``nproc`` ranks on the CPU; its ``.npz`` as a dict."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo)
    proc = run_torchrun(nproc, [os.path.join(repo, "tests", script), inputs, out],
                        timeout, cwd=repo, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}
