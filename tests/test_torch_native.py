"""The port's binding to the C++ tokenizers and row packer
(``mmtg_tpu_torch.native``): WordPiece and byte-level BPE ids equal to the
port's Python path and to the JAX package's binding, the packed token
columns bit-identical to the Python framing, the libraries built from
``native/*.cc`` under ``build/native/`` while the tracked ``native/*.so``
stay as they are."""

import glob
import os
import threading

import numpy as np
import pytest

from mmtg_tpu import native as jnative
from mmtg_tpu.data import MMTGDataset as JaxDataset
from mmtg_tpu_torch import native
from mmtg_tpu_torch.bpe import ByteLevelBPETokenizer, train_bpe
from mmtg_tpu_torch.configs import DataConfig
from mmtg_tpu_torch.data import MMTGDataset
from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

from test_native_packer import TOKEN_KEYS, _records

TEXTS = [
    "青山一道同云雨，明月何曾是两乡",
    "Hello, WORLD! naïve café — déjà vu",
    "mixed 雪山 English 123 tokens... ？！",
    "tab\there and\nnewline\r\n  spaces",
    "",
    "unknownwordpiecesxyzzy ##notatoken [UNK] [SEP]",
]
CORPUS = ["city lights are calling out my name tonight",
          "we dance until the morning sun comes up",
          "hold me closer while the music plays, it's 3 a.m."]


@pytest.fixture(scope="module")
def cxx():
    path = native.compiler()
    if path is None:
        pytest.skip("no C++ compiler (g++ / c++ / $CXX) on PATH: the native "
                    "libraries cannot be built, the Python path is used")
    return path


@pytest.fixture(scope="module")
def wordpiece(cxx, reference_vocab_path):
    tk = WordPieceTokenizer.from_file(reference_vocab_path)
    assert tk.native is not None
    return tk, WordPieceTokenizer.from_file(reference_vocab_path, use_native=False)


def _so_bytes():
    out = {}
    for path in sorted(glob.glob(os.path.join(native.NATIVE_SRC, "*.so"))):
        with open(path, "rb") as f:
            out[path] = f.read()
    return out


def test_libraries_build_under_build_native_and_leave_native_alone(
        cxx, tmp_path, monkeypatch):
    before = _so_bytes()
    assert set(map(os.path.basename, before)) == {"libbpe.so", "libwordpiece.so"}
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    for name in ("wordpiece", "bpe"):
        path = native.build(name)
        assert os.path.dirname(path) == str(tmp_path / "native")
        assert os.path.basename(path).startswith(f"lib{name}_")
        assert native.build(name) == path  # built once, then reused
    assert _so_bytes() == before
    monkeypatch.undo()
    for name in ("wordpiece", "bpe"):
        lib = native.load(name)
        assert os.path.dirname(lib._name) == os.path.join(
            os.path.dirname(native.NATIVE_SRC), "build", "native")


def test_loaders_return_none_without_a_compiler(monkeypatch, reference_vocab_path,
                                                tmp_path):
    monkeypatch.setattr(native, "compiler", lambda: None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_libs", {})
    assert native.load_native_tokenizer(reference_vocab_path) is None
    tk = WordPieceTokenizer.from_file(reference_vocab_path)
    assert tk.native is None and tk.encode("雪山") == tk.convert_tokens_to_ids(
        tk.tokenize("雪山"))


def test_wordpiece_ids_equal_python_and_the_jax_binding(wordpiece, reference_vocab_path):
    fast, slow = wordpiece
    theirs = jnative.load_native_tokenizer(reference_vocab_path)
    for text in TEXTS:
        ids = fast.encode(text)
        assert ids == slow.encode(text) == fast.native.tokenize_to_ids(text), text
        if theirs is not None:
            assert ids == theirs.tokenize_to_ids(text), text
    # past the 4096 ids of the first buffer (the C side would truncate)
    long = "明月何曾是两乡" * 1000
    assert len(fast.native.tokenize_to_ids(long)) == 7000
    assert fast.native.tokenize_to_ids(long) == slow.encode(long)
    assert fast.encode("a\0b") == slow.encode("a\0b")  # NUL: the Python path


@pytest.fixture(scope="module")
def bpe_dir(cxx, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bpe"))
    train_bpe(CORPUS, vocab_size=400).save(root)
    return root


def test_bpe_ids_equal_python_and_the_jax_binding(bpe_dir):
    vj, mt = os.path.join(bpe_dir, "vocab.json"), os.path.join(bpe_dir, "merges.txt")
    fast = ByteLevelBPETokenizer.from_dir(bpe_dir)
    slow = ByteLevelBPETokenizer.from_dir(bpe_dir, use_native=False)
    assert fast.native is not None and slow.native is None
    theirs = jnative.load_native_bpe(vj, mt)
    for text in CORPUS + TEXTS + [" ".join(CORPUS) * 300]:
        ids = fast.encode(text)
        assert ids == slow.encode(text), text[:40]
        if theirs is not None and len(ids) < 8192:
            assert ids == theirs.encode(text), text[:40]


def test_bpe_handle_is_safe_across_threads(bpe_dir):
    """The C encoder caches words in its handle: 16 threads on one
    tokenizer, a short switch interval, every result the Python path's."""
    import sys

    fast = ByteLevelBPETokenizer.from_dir(bpe_dir)
    slow = ByteLevelBPETokenizer.from_dir(bpe_dir, use_native=False)
    texts = [f"{CORPUS[i % 3]} {i} {'x' * (i % 7)}" for i in range(64)]
    want = [slow.encode(t) for t in texts]
    bad = []

    def work(k):
        for j in range(8):
            i = (k * 8 + j) % len(texts)
            if fast.encode(texts[i]) != want[i]:
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_pack_rows_columns_bit_identical(wordpiece, tokenizer):
    """The JAX package's framing edge cases (long topics, truncated
    sentences, spaces the scrub joins, empty sentences): the native packer's
    columns equal the Python framing's and the JAX dataset's, bit for bit."""
    fast, slow = wordpiece
    recs = _records(n=12)
    cfg = DataConfig()
    via_native = MMTGDataset.from_records(recs, fast, cfg, if_train=True).arrays()
    via_python = MMTGDataset.from_records(recs, slow, cfg, if_train=True).arrays()
    jax_cols = JaxDataset.from_records(recs, tokenizer, cfg, if_train=True).arrays()
    direct = fast.native.pack_rows(
        [r["topic"] for r in recs], [r["lyrics"] for r in recs],
        topic_len=cfg.topic_prompt_length, max_sent=cfg.max_sent_length,
        pad_id=slow.pad_token_id, start_id=slow.convert_tokens_to_ids("[#START#]"),
        eos_id=slow.convert_tokens_to_ids("[#EOS#]"), sep_id=slow.sep_token_id)
    for k in TOKEN_KEYS:
        assert via_native[k].dtype == via_python[k].dtype == np.int32
        np.testing.assert_array_equal(via_native[k], via_python[k], err_msg=k)
        np.testing.assert_array_equal(direct[k], via_python[k], err_msg=k)
        np.testing.assert_array_equal(jax_cols[k], via_python[k], err_msg=k)


def test_pack_rows_outside_its_contract_takes_the_python_framing(wordpiece):
    """A NUL inside a sentence (where a C string would end): the Python
    framing, the same columns with or without the native tokenizer; a
    sentence count off the grid: the Python framing, which raises with
    either tokenizer."""
    fast, slow = wordpiece
    recs = _records(n=2)
    recs[0]["lyrics"][1] = "青山\0一道"
    a = MMTGDataset.from_records(recs, fast, DataConfig(), if_train=True).arrays()
    b = MMTGDataset.from_records(recs, slow, DataConfig(), if_train=True).arrays()
    for k in TOKEN_KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    recs = _records(n=2)
    recs[1]["lyrics"] = recs[1]["lyrics"] + ["额外的一句"]  # 11 sentences
    for tk in (slow, fast):
        with pytest.raises(ValueError):
            MMTGDataset.from_records(recs, tk, DataConfig(), if_train=True)
