"""The port's own copy of the sequence packer vs the JAX package's: the same
columns and the same shuffle seed give the same arrays, exactly."""

import numpy as np
import pytest

from mmtg_tpu import pack as jpack
from mmtg_tpu.configs import DataConfig as JDataConfig
from mmtg_tpu_torch import pack as tpack
from mmtg_tpu_torch.configs import DataConfig

JD, TD = JDataConfig(wenlan_emb_size=32), DataConfig(wenlan_emb_size=32)


def _lens(seed, n, lo=2, hi=18):
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(lo, hi)) for _ in range(10)] for _ in range(n)]


def _both_cols(seed, lens, **kw):
    a = jpack.synthetic_framed_cols(np.random.default_rng(seed), JD, lens, **kw)
    b = tpack.synthetic_framed_cols(np.random.default_rng(seed), TD, lens, **kw)
    return a, b


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [dict(emb_size=32), dict(n_windows=3, vocab_high=190), {}],
                         ids=["emb32", "win3", "defaults"])
def test_synthetic_framed_cols_equal_for_the_same_generator(kw):
    a, b = _both_cols(0, _lens(1, 5), **kw)
    _same(a, b)
    assert a["targets"].shape == (5, TD.target_length)


@pytest.mark.parametrize("lens", [[[7, 3, 20, 0, 12, 5, 1, 20, 9, 2]], [[20] * 10],
                                  [[0] * 10]], ids=["mixed", "padfree", "empty"])
def test_compact_sample_equal(lens):
    a, b = _both_cols(2, lens, emb_size=32)
    b["tpw_attention_mask"][0, 11:] = 0  # a short topic prompt
    args = lambda c: (c["topic_ids"][0], b["tpw_attention_mask"][0],  # noqa: E731
                      c["tpw_type_ids"][0], c["targets"][0], c["type_ids"][0])
    _same(jpack.compact_sample(*args(a), JD), tpack.compact_sample(*args(b), TD))


@pytest.mark.parametrize("row_len,max_slots,rows,shuffle", [
    (256, 4, 2, False), (512, 8, 4, True), (236, 1, 3, True), (384, 2, 8, True)])
def test_packed_batches_equal(row_len, max_slots, rows, shuffle):
    a, b = _both_cols(3, _lens(4, 13), emb_size=32)
    ja = jpack.PackedBatcher(a, JD, row_len=row_len, max_slots=max_slots)
    tb = tpack.PackedBatcher(b, TD, row_len=row_len, max_slots=max_slots)
    assert ja.density == tb.density and tb.n == 13
    order = np.random.default_rng(9).permutation(13)
    assert ja.pack_order(order) == tb.pack_order(order)
    jb = list(ja.batches(rows, shuffle=shuffle, rng=np.random.default_rng(5)))
    tt = list(tb.batches(rows, shuffle=shuffle, rng=np.random.default_rng(5)))
    assert len(jb) == len(tt) > 0
    for x, y in zip(jb, tt):
        _same(x, y)
    assert sum(int(y["slot_valid"].sum()) for y in tt) == 13  # each sample once


def test_packing_is_next_fit_not_first_fit():
    """A closed row is never reopened: a short sample that would still fit
    an earlier row starts or joins the current one."""
    lens = [[20] * 10, [20] * 10, [2] * 10]  # 236, 236, 56 compact tokens
    _, cols = _both_cols(6, lens, emb_size=32)
    pb = tpack.PackedBatcher(cols, TD, row_len=300, max_slots=4)
    assert pb.pack_order(np.arange(3)) == [[0], [1, 2]]


def test_packer_rejects_a_sample_longer_than_the_row():
    _, cols = _both_cols(7, [[20] * 10], emb_size=32)
    with pytest.raises(ValueError, match="row_len=128"):
        tpack.PackedBatcher(cols, TD, row_len=128)
