"""Reference ``.pth`` import / export (:mod:`mmtg_tpu.checkpoint`).

The reference model is itself PyTorch, so this is a direct name map between
its ``MMTG.state_dict()`` (``model.py:330-354``; optionally
``module.``-prefixed by ``nn.DataParallel``) and the port's parameter tree:
``nn.Linear`` / ``nn.GRU`` weights are transposed to ``x @ W`` orientation
and the per-layer GPT-2 tensors are stacked.

Train states (:func:`save_train_state` / :func:`restore_train_state`) are
written in the port's own format, one ``torch.save`` file per step;
:func:`load_model_params` reads the parameters of either kind of file.
Reading the JAX package's Orbax directories is not ported yet.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import torch

from mmtg_tpu_torch.configs import ModelConfig
from mmtg_tpu_torch.models.gpt2 import export_hf_gpt2, import_hf_gpt2


def strip_prefix(state: Dict, prefix: str = "module.") -> Dict:
    """Drop the ``nn.DataParallel`` wrapper prefix."""
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):] if k.startswith(prefix) else k: v
                for k, v in state.items()}
    return state


def import_reference_state_dict(state: Dict[str, torch.Tensor],
                                mcfg: ModelConfig) -> Dict:
    """Reference ``MMTG.state_dict()`` → the port's parameter tree (CPU
    tensors in the state dict's dtype)."""
    state = strip_prefix(state)
    get = lambda k: torch.as_tensor(state[k]).detach()  # noqa: E731

    def linear(name):
        return {"w": get(f"{name}.weight").T.contiguous(),
                "b": get(f"{name}.bias").clone()}

    def ln(name):
        return {"g": get(f"{name}.weight").clone(),
                "b": get(f"{name}.bias").clone()}

    def gru(prefix, num_layers):
        return {"layers": [
            {"w_ih": get(f"{prefix}.weight_ih_l{k}").T.contiguous(),
             "w_hh": get(f"{prefix}.weight_hh_l{k}").T.contiguous(),
             "b_ih": get(f"{prefix}.bias_ih_l{k}").clone(),
             "b_hh": get(f"{prefix}.bias_hh_l{k}").clone()}
            for k in range(num_layers)]}

    def alpha(prefix):
        return {s: linear(f"{prefix}.{s}") for s in ("query", "key", "value")}

    T = mcfg.seq_len
    gpt2_state = {k[len("decoder.gpt2."):]: v for k, v in state.items()
                  if k.startswith("decoder.gpt2.")}
    return {
        "encoder": {
            "topic_fc": linear("encoder.topic_fc"),
            "image": gru("encoder.rnns_image", mcfg.image.num_layers),
            "text": gru("encoder.rnns_text", mcfg.text.num_layers),
        },
        "ln_topic": ln("ln_layer1"),
        "ln_image": ln("ln_layer2"),
        "ln_text": ln("ln_layer3"),
        "alpha_img": alpha("img_inner_atten_layer"),
        "alpha_text": alpha("text_inner_atten_layer"),
        "beta": {
            "att_w": torch.stack([get(f"mm_atten_layer.att_matrices.{i}.weight").T
                                  for i in range(T)]),
            "att_b": torch.stack([get(f"mm_atten_layer.att_matrices.{i}.bias")
                                  for i in range(T)]),
            "out": linear("mm_atten_layer.out_linear"),
        },
        "projector1": linear("decoder.projector_layer1"),
        "projector2": linear("decoder.projector_layer2"),
        "gpt2": import_hf_gpt2(gpt2_state, mcfg.gpt2),
    }


def export_reference_state_dict(params: Dict, mcfg: ModelConfig
                                ) -> Dict[str, torch.Tensor]:
    """The port's parameter tree → a reference ``MMTG.state_dict()``-shaped
    dict of CPU tensors (inverse of :func:`import_reference_state_dict`)."""
    out: Dict[str, torch.Tensor] = {}
    t = lambda x: x.detach().cpu()  # noqa: E731

    def put_linear(name, p):
        out[f"{name}.weight"] = t(p["w"]).T.contiguous()
        out[f"{name}.bias"] = t(p["b"]).clone()

    def put_ln(name, p):
        out[f"{name}.weight"] = t(p["g"]).clone()
        out[f"{name}.bias"] = t(p["b"]).clone()

    def put_gru(prefix, p):
        for k, layer in enumerate(p["layers"]):
            out[f"{prefix}.weight_ih_l{k}"] = t(layer["w_ih"]).T.contiguous()
            out[f"{prefix}.weight_hh_l{k}"] = t(layer["w_hh"]).T.contiguous()
            out[f"{prefix}.bias_ih_l{k}"] = t(layer["b_ih"]).clone()
            out[f"{prefix}.bias_hh_l{k}"] = t(layer["b_hh"]).clone()

    put_linear("encoder.topic_fc", params["encoder"]["topic_fc"])
    put_gru("encoder.rnns_image", params["encoder"]["image"])
    put_gru("encoder.rnns_text", params["encoder"]["text"])
    put_ln("ln_layer1", params["ln_topic"])
    put_ln("ln_layer2", params["ln_image"])
    put_ln("ln_layer3", params["ln_text"])
    for pre, key in (("img_inner_atten_layer", "alpha_img"),
                     ("text_inner_atten_layer", "alpha_text")):
        for sub in ("query", "key", "value"):
            put_linear(f"{pre}.{sub}", params[key][sub])
    for i in range(mcfg.seq_len):
        out[f"mm_atten_layer.att_matrices.{i}.weight"] = (
            t(params["beta"]["att_w"][i]).T.contiguous())
        out[f"mm_atten_layer.att_matrices.{i}.bias"] = (
            t(params["beta"]["att_b"][i]).clone())
    put_linear("mm_atten_layer.out_linear", params["beta"]["out"])
    put_linear("decoder.projector_layer1", params["projector1"])
    put_linear("decoder.projector_layer2", params["projector2"])
    out.update(export_hf_gpt2(params["gpt2"], mcfg.gpt2, prefix="decoder.gpt2."))
    return out


def load_reference_checkpoint(path: str, mcfg: ModelConfig) -> Dict:
    """Load a reference ``.pth`` (``{'model': state_dict, ...}``, a
    ``{'state_dict': ...}`` wrapper or a bare state dict). Reference
    checkpoints pickle their argparse namespace, so this unpickles the file:
    load only checkpoints you trust."""
    return _import_raw(torch.load(path, map_location="cpu", weights_only=False),
                       mcfg)


def _is_train_state(raw) -> bool:
    """A :func:`save_train_state` file, told from a reference state dict by
    its keys (its ``params`` hold the port's parameter tree)."""
    return isinstance(raw, dict) and {"params", "opt_state", "step"} <= raw.keys()


def load_model_params(path: str, mcfg: ModelConfig) -> Dict:
    """The parameter tree (CPU tensors) of one checkpoint file: a train
    state's ``params`` (the f32 masters), or a reference checkpoint as
    :func:`load_reference_checkpoint` reads it. Unpickles: load only files
    you trust."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if _is_train_state(raw):
        return raw["params"]
    return _import_raw(raw, mcfg)


def _import_raw(raw, mcfg: ModelConfig) -> Dict:
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return import_reference_state_dict(raw, mcfg)


def save_reference_checkpoint(path: str, params: Dict, mcfg: ModelConfig) -> None:
    """Write ``{'model': state_dict, 'args', 'model_cfgs'}`` with the
    ``module.`` prefix the reference's loader strips."""
    sd = export_reference_state_dict(params, mcfg)
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "args": {}, "model_cfgs": {}}, path)


def _step_files(directory: str):
    return sorted(glob.glob(os.path.join(directory, "step_*.pt")))


def newest_step_file(model_path: str) -> str:
    """The checkpoint file a model path names, as the JAX package's
    ``generate.load_params`` resolves a trainer's ``--save_path``: a file is
    itself; a directory holding ``step_*.pt`` files gives its newest; else the
    newest of ``train_state_best/`` (the best-val stream, preferred) and then
    of ``train_state/``. Raises ``FileNotFoundError`` naming what it looked
    in."""
    if not os.path.isdir(model_path):
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"no checkpoint at {model_path}")
        return model_path
    candidates = [model_path, os.path.join(model_path, "train_state_best"),
                  os.path.join(model_path, "train_state")]
    for directory in candidates:
        files = _step_files(directory)
        if files:
            return files[-1]
    raise FileNotFoundError(f"no step_*.pt checkpoint under {candidates}")


def save_train_state(directory: str, step: int, state, keep: int = 5) -> str:
    """Write ``state`` (a :class:`mmtg_tpu_torch.train.TrainState`) to
    ``<directory>/step_<step>.pt`` — parameters, AdamW state, step and the
    dropout generator's state, as CPU tensors — and delete all but the
    ``keep`` newest files. Returns the file's path."""
    from mmtg_tpu_torch.params import tree_map

    os.makedirs(directory, exist_ok=True)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    path = os.path.join(directory, f"step_{int(step):08d}.pt")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"params": tree_map(cpu, state.params),
                "opt_state": tree_map(cpu, state.opt_state),
                "step": int(state.step),
                "rng_state": state.rng.get_state()}, tmp)
    os.replace(tmp, path)
    for old in _step_files(directory)[:-keep]:
        os.remove(old)
    return path


def restore_train_state(directory: str, state) -> Tuple[object, int]:
    """Load the newest ``step_*.pt`` of ``directory`` INTO ``state`` (its
    tensors keep their device and are overwritten in place; the tree must
    match). Returns ``(state, step)``, or ``(state, -1)`` unchanged when the
    directory holds no checkpoint."""
    from mmtg_tpu_torch.params import tree_map

    files = _step_files(directory)
    if not files:
        return state, -1
    raw = torch.load(files[-1], map_location="cpu", weights_only=True)

    def load_into(dst, src):
        with torch.no_grad():
            dst.copy_(src)
        return dst

    tree_map(load_into, state.params, raw["params"])
    tree_map(load_into, state.opt_state, raw["opt_state"])
    state.rng.set_state(raw["rng_state"])
    return state._replace(step=int(raw["step"])), int(raw["step"])
