"""GRU scan with torch-exact numerics (:func:`mmtg_tpu.ops.rnn.rnn_forward`).

Params keep the JAX package's layout: ``{"layers": [{"w_ih": [in, 3H],
"w_hh": [H, 3H], "b_ih": [3H], "b_hh": [3H]}, ...]}`` (``x @ W``
orientation). Gates are stacked [r, z, n];
``n = tanh(Wx + b_in + r * (Uh + b_hn))`` — the hidden bias sits inside the
reset product, as in ``torch.nn.GRU``. Differentiable under autograd (the
train step runs this scan, as the JAX package does). Inter-layer dropout only
(torch semantics: between layers when there are several; the reference's
single-layer GRUs see none). The LSTM / RNN cells are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def rnn_forward(params: Dict[str, List[Dict[str, torch.Tensor]]],
                x: torch.Tensor, kind: str = "GRU",
                dropout_rate: float = 0.0,
                dropout_gen: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a (multi-layer) GRU stack over ``x`` ``[T, B, in]`` in x's
    dtype. Returns (outputs ``[T, B, H]``, final hidden ``[layers, B, H]``).
    With ``dropout_gen`` (a generator on any device: it only draws the
    mask's seed) and ``dropout_rate > 0`` the outputs between layers are
    dropped out."""
    if kind != "GRU":
        raise NotImplementedError(f"rnn kind {kind!r}: only GRU is ported")
    finals = []
    out = x
    n_layers = len(params["layers"])
    for li, lp in enumerate(params["layers"]):
        H = lp["w_hh"].shape[0]
        x_proj = out @ lp["w_ih"] + lp["b_ih"]  # [T, B, 3H], one matmul
        h = torch.zeros(x.shape[1], H, dtype=x.dtype, device=x.device)
        ys = []
        for t in range(x_proj.shape[0]):
            xr, xz, xn = x_proj[t].split(H, dim=-1)
            hr, hz, hn = (h @ lp["w_hh"] + lp["b_hh"]).split(H, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
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
