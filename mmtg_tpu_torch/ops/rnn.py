"""Recurrent cells with torch-exact numerics (:func:`mmtg_tpu.ops.rnn.rnn_forward`).

Params keep the JAX package's layout: ``{"layers": [{"w_ih": [in, G·H],
"w_hh": [H, G·H], "b_ih": [G·H], "b_hh": [G·H]}, ...]}`` (``x @ W``
orientation; ``G`` gates: 3 for GRU, 4 for LSTM, 1 for RNN), so a reference
``nn.GRU`` / ``nn.LSTM`` / ``nn.RNN`` state dict imports by a transpose:

  * GRU gates stacked [r, z, n]; ``n = tanh(Wx + b_in + r * (Uh + b_hn))`` —
    the hidden bias sits inside the reset product, as in ``torch.nn.GRU``.
  * LSTM gates stacked [i, f, g, o]; ``c' = σ(f)·c + σ(i)·tanh(g)``,
    ``h' = σ(o)·tanh(c')``.
  * RNN(relu): ``h' = relu(Wx + b_ih + Uh + b_hh)``.

Differentiable under autograd (the train step runs this scan, as the JAX
package does). Inter-layer dropout only (torch semantics: between layers
when there are several; the reference's single-layer channels see none).
The products go through ``mm`` (``x @ w (+ bias)``, the bias where the JAX
formula adds it to the product alone): the plain product for training, the
batch-invariant kernel (:func:`mmtg_tpu_torch.ops.matmul.matmul`) at
inference, so a row's state does not depend on the rows beside it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from mmtg_tpu_torch.ops.matmul import matmul_plain

GATES = {"RNN": 1, "GRU": 3, "LSTM": 4}


def _gru_step(xp, h, c, w, b, mm):
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = mm(h, w, b).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, c


def _lstm_step(xp, h, c, w, b, mm):
    i, f, g, o = (xp + mm(h, w) + b).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _relu_step(xp, h, c, w, b, mm):
    return torch.relu(xp + mm(h, w) + b), c


_STEPS = {"GRU": _gru_step, "LSTM": _lstm_step, "RNN": _relu_step}


def rnn_forward(params: Dict[str, List[Dict[str, torch.Tensor]]],
                x: torch.Tensor, kind: str = "GRU",
                dropout_rate: float = 0.0,
                dropout_gen: Optional[torch.Generator] = None,
                mm=matmul_plain) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a (multi-layer) ``kind`` stack (``"GRU"``, ``"LSTM"`` or
    ``"RNN"``) over ``x`` ``[T, B, in]`` in x's dtype. Returns (outputs
    ``[T, B, H]``, final hidden ``[layers, B, H]``; for an LSTM the final
    h's, not the c's). With ``dropout_gen`` (a generator on any device: it
    only draws the mask's seed) and ``dropout_rate > 0`` the outputs between
    layers are dropped out. ``mm(x, w, bias=None)``: each layer's input
    projection (``[T·B, in] @ [in, G·H]``) and each step's ``h @ w_hh``
    (``[B, H] @ [H, G·H]``); ``ops.matmul.matmul`` at inference."""
    if kind not in _STEPS:
        raise ValueError(f"unknown rnn kind: {kind!r} (one of {sorted(_STEPS)})")
    step = _STEPS[kind]
    finals = []
    out = x
    n_layers = len(params["layers"])
    for li, lp in enumerate(params["layers"]):
        H = lp["w_hh"].shape[0]
        x_proj = mm(out, lp["w_ih"], lp["b_ih"])  # [T, B, G·H], one product
        h = torch.zeros(x.shape[1], H, dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        ys = []
        for t in range(x_proj.shape[0]):
            h, c = step(x_proj[t], h, c, lp["w_hh"], lp["b_hh"], mm)
            ys.append(h)
        finals.append(h)
        out = torch.stack(ys)
        if dropout_rate > 0.0 and dropout_gen is not None and li < n_layers - 1:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=dropout_gen,
                                     device=dropout_gen.device))
            gen = torch.Generator(device=out.device).manual_seed(seed)
            keep = torch.rand(out.shape, generator=gen,
                              device=out.device) >= dropout_rate
            out = torch.where(keep, out / (1.0 - dropout_rate),
                              torch.zeros_like(out))
    return out, torch.stack(finals)
