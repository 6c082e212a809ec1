"""Reference ``.pth`` import / export (:mod:`mmtg_tpu.checkpoint`).

The reference model is itself PyTorch, so this is a direct name map between
its ``MMTG.state_dict()`` (``model.py:330-354``; optionally
``module.``-prefixed by ``nn.DataParallel``) and the port's parameter tree:
``nn.Linear`` and ``nn.GRU`` / ``nn.LSTM`` / ``nn.RNN`` weights are
transposed to ``x @ W`` orientation (a stack's gate count follows from the
shapes) and the per-layer GPT-2 tensors are stacked. A TRM channel has no
reference names (the reference never implements it): a model with one
raises on ``.pth`` import and export, and travels in the port's own train
states.

Train states (:func:`save_train_state` / :func:`restore_train_state`) are
written in the port's own format, one ``torch.save`` file per step;
:func:`load_model_params` reads the parameters of either kind of file.
A JAX run's Orbax train state becomes such a file with
``scripts/orbax_to_torch.py`` (outside the package: it needs JAX and Orbax).

:func:`read_safetensors` / :func:`write_safetensors` read and write the
``safetensors`` format (a Hugging Face snapshot's ``model.safetensors``) by
hand, without the ``safetensors`` package.
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Dict, Optional

import torch

from mmtg_tpu_torch.configs import ModelConfig
from mmtg_tpu_torch.models.gpt2 import export_hf_gpt2, import_hf_gpt2


def strip_prefix(state: Dict, prefix: str = "module.") -> Dict:
    """Drop the ``nn.DataParallel`` wrapper prefix."""
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):] if k.startswith(prefix) else k: v
                for k, v in state.items()}
    return state


def _check_reference_channels(mcfg: ModelConfig) -> None:
    for name, ch in (("image", mcfg.image), ("text", mcfg.text)):
        if ch.type == "TRM":
            raise ValueError(
                f"the {name} channel is a TRM channel, which the reference "
                "model never implements: it has no .pth names (the port's "
                "step_*.pt train states carry it)")


def import_reference_state_dict(state: Dict[str, torch.Tensor],
                                mcfg: ModelConfig) -> Dict:
    """Reference ``MMTG.state_dict()`` → the port's parameter tree (CPU
    tensors in the state dict's dtype)."""
    _check_reference_channels(mcfg)
    state = strip_prefix(state)
    get = lambda k: torch.as_tensor(state[k]).detach()  # noqa: E731

    def linear(name):
        return {"w": get(f"{name}.weight").T.contiguous(),
                "b": get(f"{name}.bias").clone()}

    def ln(name):
        return {"g": get(f"{name}.weight").clone(),
                "b": get(f"{name}.bias").clone()}

    def rnn(prefix, num_layers):
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
            "image": rnn("encoder.rnns_image", mcfg.image.num_layers),
            "text": rnn("encoder.rnns_text", mcfg.text.num_layers),
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
    _check_reference_channels(mcfg)
    out: Dict[str, torch.Tensor] = {}
    t = lambda x: x.detach().cpu()  # noqa: E731

    def put_linear(name, p):
        out[f"{name}.weight"] = t(p["w"]).T.contiguous()
        out[f"{name}.bias"] = t(p["b"]).clone()

    def put_ln(name, p):
        out[f"{name}.weight"] = t(p["g"]).clone()
        out[f"{name}.bias"] = t(p["b"]).clone()

    def put_rnn(prefix, p):
        for k, layer in enumerate(p["layers"]):
            out[f"{prefix}.weight_ih_l{k}"] = t(layer["w_ih"]).T.contiguous()
            out[f"{prefix}.weight_hh_l{k}"] = t(layer["w_hh"]).T.contiguous()
            out[f"{prefix}.bias_ih_l{k}"] = t(layer["b_ih"]).clone()
            out[f"{prefix}.bias_hh_l{k}"] = t(layer["b_hh"]).clone()

    put_linear("encoder.topic_fc", params["encoder"]["topic_fc"])
    put_rnn("encoder.rnns_image", params["encoder"]["image"])
    put_rnn("encoder.rnns_text", params["encoder"]["text"])
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


def save_train_state(directory: str, step: int, state, keep: int = 5,
                     epoch: Optional[int] = None) -> str:
    """Write ``state`` (a :class:`mmtg_tpu_torch.train.TrainState`) to
    ``<directory>/step_<step>.pt`` — parameters, AdamW state, step and the
    dropout generator's state, as CPU tensors, and ``epoch``, the epoch a
    resumed run starts at, when given — and delete all but the ``keep``
    newest files. Returns the file's path."""
    from mmtg_tpu_torch.params import tree_map

    os.makedirs(directory, exist_ok=True)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    path = os.path.join(directory, f"step_{int(step):08d}.pt")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"params": tree_map(cpu, state.params),
                "opt_state": tree_map(cpu, state.opt_state),
                "step": int(state.step),
                "rng_state": state.rng.get_state(),
                **({} if epoch is None else {"epoch": int(epoch)})}, tmp)
    os.replace(tmp, path)
    for old in _step_files(directory)[:-keep]:
        os.remove(old)
    return path


def restore_train_state(directory: str, state, with_epoch: bool = False):
    """Load the newest ``step_*.pt`` of ``directory`` INTO ``state`` (its
    tensors keep their device and are overwritten in place; the tree must
    match). Returns ``(state, step)``, or ``(state, -1)`` unchanged when the
    directory holds no checkpoint; ``with_epoch``: ``(state, step, epoch)``,
    ``epoch`` the saved epoch to resume at, ``None`` for a state saved
    without one (``scripts/orbax_to_torch.py``'s)."""
    from mmtg_tpu_torch.params import tree_map

    files = _step_files(directory)
    if not files:
        return (state, -1, None) if with_epoch else (state, -1)
    raw = torch.load(files[-1], map_location="cpu", weights_only=True)

    def load_into(dst, src):
        with torch.no_grad():
            dst.copy_(src)
        return dst

    tree_map(load_into, state.params, raw["params"])
    tree_map(load_into, state.opt_state, raw["opt_state"])
    state.rng.set_state(raw["rng_state"])
    state = state._replace(step=int(raw["step"]))
    if with_epoch:
        return state, int(raw["step"]), raw.get("epoch")
    return state, int(raw["step"])


# safetensors: an 8-byte little-endian header length, a JSON header mapping
# each name to its dtype, shape and [begin, end) byte offsets into the data
# that follows (an optional "__metadata__" entry of strings), raw
# little-endian tensor bytes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
              "BOOL": torch.bool}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors in their
    stored dtype. Raises ``ValueError`` on a malformed file or a dtype
    outside F64 / F32 / F16 / BF16 / I64 / I32 / I16 / I8 / U8 / BOOL."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = int.from_bytes(data[:8], "little")
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes runs past the file")
    header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']!r}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        shape = [int(d) for d in info["shape"]]
        lo, hi = (int(o) for o in info["data_offsets"])
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        if hi - lo != nbytes or lo < 0 or base + hi > len(data):
            raise ValueError(f"{path}: {name} {info['dtype']}{shape} does not "
                             f"fit its offsets [{lo}, {hi})")
        flat = torch.empty(0, dtype=dtype)
        if nbytes:  # a copy: aligned, and independent of the file's buffer
            flat = torch.frombuffer(data, dtype=torch.uint8, count=nbytes,
                                    offset=base + lo).clone().view(dtype)
        out[name] = flat.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` (names sorted, each contiguous on the CPU) as one
    ``.safetensors`` file that :func:`read_safetensors` and the
    ``safetensors`` package read."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _ST_CODES:
            raise ValueError(f"write_safetensors: {name} has dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)
