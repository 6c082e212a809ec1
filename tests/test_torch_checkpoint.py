"""Reference ``.pth`` name map: the port's export / import vs the JAX
package's, in both directions."""

import jax
import numpy as np
import torch

from mmtg_tpu.checkpoint import (
    export_reference_state_dict as jax_export,
    import_reference_state_dict as jax_import,
)
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch.checkpoint import (
    export_reference_state_dict,
    import_reference_state_dict,
    load_reference_checkpoint,
    save_reference_checkpoint,
)

torch.set_num_threads(2)


def _np_params(mcfg, seed):
    return tparams.to_numpy(tparams.init_params(mcfg, seed=seed))


def test_port_export_then_jax_import(tiny_model_cfg):
    p = _np_params(tiny_model_cfg, 0)
    sd = export_reference_state_dict(tparams.from_jax_numpy(p), tiny_model_cfg)
    back = jax_import(sd, tiny_model_cfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(b), a),
                 p, back)


def test_jax_export_then_port_import(tiny_model_cfg):
    p = _np_params(tiny_model_cfg, 1)
    sd = jax_export(jax.tree.map(np.asarray, p), tiny_model_cfg)
    back = tparams.to_numpy(import_reference_state_dict(sd, tiny_model_cfg))
    jax.tree.map(np.testing.assert_array_equal, back, p)


def test_export_matches_jax_export_names(tiny_model_cfg):
    p = _np_params(tiny_model_cfg, 2)
    ours = export_reference_state_dict(tparams.from_jax_numpy(p), tiny_model_cfg)
    theirs = jax_export(jax.tree.map(np.asarray, p), tiny_model_cfg)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].is_contiguous()
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy())


def test_save_load_roundtrip(tiny_model_cfg, tmp_path):
    p = tparams.init_params(tiny_model_cfg, seed=3)
    path = str(tmp_path / "model.pth")
    save_reference_checkpoint(path, p, tiny_model_cfg)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert all(k.startswith("module.") for k in raw["model"])
    back = load_reference_checkpoint(path, tiny_model_cfg)
    jax.tree.map(np.testing.assert_array_equal, tparams.to_numpy(back),
                 tparams.to_numpy(p))
