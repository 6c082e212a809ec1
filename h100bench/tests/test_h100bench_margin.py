"""The sampling margin of the generate check against a search: the least
shift of the logits (the token up, every other down) that puts the token
in the program's own sampling set."""

import pytest
import torch

from h100bench import harness
from mmtg_tpu_torch.ops.sampling import NEG_INF, _nucleus_mask_sorted, top_k_sorted

generate = harness.driver("generate")


def _in_set(x, t, temperature, k, p):
    vals, idx = top_k_sorted(x[None] / temperature, k)
    vals = _nucleus_mask_sorted(vals, p)
    return bool(((idx[0] == t) & (vals[0] > NEG_INF / 2)).any())


def _searched(x, t, temperature, k, p, step=1e-4):
    d = 0.0
    while True:
        y = x - d
        y[t] += 2 * d
        if _in_set(y, t, temperature, k, p):
            return d
        d += step


@pytest.mark.parametrize("k,p", [(10, 1.0), (10, 0.7), (3, 0.5)])
def test_margin_against_a_search(k, p):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(6, 48, generator=g, dtype=torch.float64).float() * 0.3
    t = torch.randint(0, 48, (6,), generator=g)
    t[0] = x[0].argmax()
    got = generate.set_margin(x, t, 1.1, k, p)
    for r in range(6):
        want = _searched(x[r].clone(), int(t[r]), 1.1, k, p)
        # a lower bound on the searched shift; exact for the top-k alone
        assert got[r] <= want + 1e-4
        if p == 1.0 or want == 0.0:
            assert got[r] == pytest.approx(want, abs=1.5e-4)
    assert got[0] == 0.0
