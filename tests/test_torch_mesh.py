"""The port's mesh module (``mmtg_tpu_torch.parallel.mesh``) against the JAX
package's, without processes: the QKV regroup, the regrouped tree and every
rank's TP shard of it equal the JAX package's ``tp_decode_params`` +
``decode_param_pspecs`` slices bit for bit at tp = 2, 3, 4; the backend rule;
``make_mesh``'s errors and its one-rank mesh."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmtg_tpu.parallel import mesh as jmesh
from mmtg_tpu_torch.configs import GPT2Config
from mmtg_tpu_torch.params import init_params, to_numpy, tree_leaves
from mmtg_tpu_torch.parallel import mesh as pmesh

from _torch_parity import to_port_config

N_HEAD, HEAD_DIM = 12, 8  # divisible by 2, 3 and 4


@pytest.fixture(scope="module")
def params(tiny_model_cfg):
    mcfg = dataclasses.replace(
        to_port_config(tiny_model_cfg),
        gpt2=GPT2Config(vocab_size=50, n_positions=64, n_ctx=64,
                        n_embd=N_HEAD * HEAD_DIM, n_layer=2, n_head=N_HEAD))
    return init_params(mcfg, seed=5)


def _jax_slice(x, spec, tp, i):
    """Rank i's block of a leaf under a JAX PartitionSpec over the model axis."""
    for dim, name in enumerate(spec):
        if name == jmesh.MODEL_AXIS:
            n = x.shape[dim] // tp
            return np.take(x, np.arange(i * n, (i + 1) * n), axis=dim)
    return x


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_regroup_equals_jax(params, tp):
    h = params["gpt2"]["h"]
    w, b = pmesh.regroup_qkv_for_tp(h["attn_w"], h["attn_b"], N_HEAD, HEAD_DIM, tp)
    jw, jb = jmesh.regroup_qkv_for_tp(np.asarray(h["attn_w"]), np.asarray(h["attn_b"]),
                                      N_HEAD, HEAD_DIM, tp)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_every_rank_shard_equals_jax_slices(params, tp):
    """The regrouped tree and, for each model index, the shard: the JAX
    package's regrouped leaf cut by its decode PartitionSpec, bit for bit;
    the replicated leaves are the same tensors, not copies."""
    jparams = to_numpy(params)
    jtp = jmesh.tp_decode_params(jparams, N_HEAD, HEAD_DIM, tp)
    specs = jmesh.decode_param_pspecs(jtp)
    ttp = pmesh.tp_decode_params(params, N_HEAD, HEAD_DIM, tp)
    for path, leaf in _paths(jtp):
        np.testing.assert_array_equal(_get(ttp, path).numpy(), np.asarray(leaf))
    splits = pmesh.decode_param_splits(ttp)
    for i in range(tp):
        shard = pmesh.decode_shard(params, N_HEAD, HEAD_DIM, tp, i)
        for path, leaf in _paths(jtp):
            spec = _get(specs, path)
            got = _get(shard, path)
            np.testing.assert_array_equal(
                got.numpy(), _jax_slice(np.asarray(leaf), spec, tp, i), err_msg=str(path))
            split = _get(splits, path)
            assert (split is None) == (jmesh.MODEL_AXIS not in tuple(spec)), path
            if split is None:
                assert got is _get(params, path)
            else:
                assert got.is_contiguous()
    assert sum(s is not None for s in tree_leaves(splits)) == 6


def test_shard_of_one_is_the_tree_and_bad_splits_raise(params):
    assert pmesh.decode_shard(params, N_HEAD, HEAD_DIM, 1, 0) is params
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.decode_shard(params, N_HEAD, HEAD_DIM, 5, 0)
    with pytest.raises(ValueError, match="shard 4 of 4"):
        pmesh.decode_shard(params, N_HEAD, HEAD_DIM, 4, 4)


@pytest.mark.parametrize("device,ranks,cards,want", [
    ("cpu", 4, 0, "gloo"),
    ("cpu", 1, 8, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 4, 8, "nccl"),
    ("cuda", 2, 1, "gloo"),  # two ranks on one card: NCCL refuses
    ("cuda", 4, 2, "gloo"),
])
def test_backend_rule(device, ranks, cards, want):
    assert pmesh.backend_for(device, ranks, cards) == want


def test_make_mesh_errors_and_one_rank_mesh(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.make_mesh((2, 1))
    with pytest.raises(ValueError, match=">= 1"):
        pmesh.make_mesh((0, 1))
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_mesh((1, 1))  # a job of one rank, as JAX's (1, 1)
        assert pmesh.mesh_sizes(mesh) == (1, 1)
        assert pmesh.mesh_coords(mesh) == (0, 0)
        assert mesh.mesh_dim_names == ("data", "model")
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="needs 4 ranks, the job has 1"):
            pmesh.make_mesh((2, 2))
        x = torch.arange(6).reshape(3, 2)
        assert pmesh.all_gather_cat(x, pmesh.groups(mesh)[0]) is x
        assert pmesh.local_rows(6, mesh) == slice(0, 6)
    finally:
        dist.destroy_process_group()
    assert jax.devices()  # the JAX side of this process is untouched
