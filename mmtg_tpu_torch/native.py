"""ctypes bindings to the native (C++) tokenizers and row packer.

The port's own binding to the shared sources ``native/wordpiece.cc`` (the
WordPiece tokenizer and ``wp_pack_rows``, the threaded row packer) and
``native/bpe.cc`` (the byte-level BPE encoder), with the C ABI that
:mod:`mmtg_tpu.native` binds. Each library is compiled from its source with
``g++ -O3 -std=c++17 -fPIC -shared -pthread`` (the flags of
``native/Makefile``) into ``build/native/lib<name>_<hash>.so`` under the
repository root (``build/`` is git-ignored); the hash covers the source and
the flags, so an edited source builds anew and an unchanged one is reused.
Nothing is built at import, nothing is written under ``native/``, and the
libraries tracked there are never loaded.

The loaders return ``None`` when no C++ compiler is found: callers then keep
the Python tokenizers and framing, which give the same ids. This is
host-side tokenisation, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from typing import Dict, List, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_I32P = ctypes.POINTER(ctypes.c_int32)


def compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, else ``g++``, else ``c++``), or ``None``."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = name and shutil.which(name)
        if path:
            return path
    return None


def library_path(name: str) -> str:
    """Where the library built from ``native/<name>.cc`` lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(os.path.join(NATIVE_SRC, f"{name}.cc"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> Optional[str]:
    """Compile ``native/<name>.cc`` unless its library is built already;
    returns the library's path, or ``None`` without a compiler. A compiler
    that fails raises with its output."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    cxx = compiler()
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run(
        [cxx, *CXXFLAGS, "-o", tmp, os.path.join(NATIVE_SRC, f"{name}.cc")],
        capture_output=True, text=True, timeout=600, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on native/{name}.cc:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _bind_wordpiece(lib: ctypes.CDLL) -> None:
    p, i32, s = ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p
    lib.wp_create.restype, lib.wp_create.argtypes = p, [s]
    lib.wp_free.restype, lib.wp_free.argtypes = None, [p]
    lib.wp_tokenize_ids.restype = i32
    lib.wp_tokenize_ids.argtypes = [p, s, _I32P, i32]
    lib.wp_pack_rows.restype = i32
    lib.wp_pack_rows.argtypes = (
        [p, ctypes.POINTER(s), ctypes.POINTER(s)]  # handle, topics, lyrics
        + [i32] * 8  # n, n_sents, topic_len, max_sent, pad, start, eos, sep
        + [_I32P] * 6  # topic ids / mask / type, targets / mask / type ids
        + [i32])  # threads (0: the library picks, at most 8)


def _bind_bpe(lib: ctypes.CDLL) -> None:
    p, i32, s = ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p
    lib.bpe_create.restype, lib.bpe_create.argtypes = p, [s, s]
    lib.bpe_free.restype, lib.bpe_free.argtypes = None, [p]
    lib.bpe_encode_ids.restype = i32
    lib.bpe_encode_ids.argtypes = [p, s, _I32P, i32]


_BINDERS = {"wordpiece": _bind_wordpiece, "bpe": _bind_bpe}


def load(name: str) -> Optional[ctypes.CDLL]:
    """The bound library ``"wordpiece"`` or ``"bpe"`` (built on first use,
    loaded once per process), or ``None`` without a compiler."""
    with _lock:
        if name not in _libs:
            path = build(name)
            if path is None:
                return None
            lib = ctypes.CDLL(path)
            _BINDERS[name](lib)
            _libs[name] = lib
        return _libs[name]


def _ids(fn, handle, text: str) -> List[int]:
    """``fn(handle, text, buffer, capacity)`` with a buffer grown until the
    ids fit (the C side truncates silently at its capacity)."""
    raw = text.encode("utf-8")
    cap = 4096
    while True:
        buf = (ctypes.c_int32 * cap)()
        n = fn(handle, raw, buf, cap)
        if n < 0:
            raise RuntimeError("native tokenizer: invalid handle")
        if n < cap:
            return list(buf[:n])
        cap *= 4


class NativeWordPiece:
    """The C++ WordPiece tokenizer of one vocab file: ids as
    :class:`mmtg_tpu_torch.tokenizer.WordPieceTokenizer` gives them, and the
    threaded row packer."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib, self._h = lib, handle
        weakref.finalize(self, lib.wp_free, handle)

    def tokenize_to_ids(self, text: str) -> List[int]:
        """Ids of ``text`` (which must hold no NUL: C strings end there)."""
        return _ids(self._lib.wp_tokenize_ids, self._h, text)

    def pack_rows(self, topics: List[str], lyrics: List[List[str]],
                  topic_len: int, max_sent: int, pad_id: int, start_id: int,
                  eos_id: int, sep_id: int) -> Dict[str, np.ndarray]:
        """The token columns of ``n`` samples in ONE native call
        (``wp_pack_rows``, threaded over samples: at most 8 threads, as many
        as the host has cores). ``lyrics`` is ``[n][n_sents]``, one sentence
        count for all. Returns int32 ``topic_ids``, ``tpw_attention_mask``,
        ``tpw_type_ids`` ``[n, topic_len]`` and ``targets``,
        ``attention_mask``, ``type_ids`` ``[n, n_sents*(max_sent+2)+1]``."""
        n = len(topics)
        if len(lyrics) != n:
            raise ValueError(f"pack_rows: {n} topics but {len(lyrics)} lyrics")
        n_sents = len(lyrics[0]) if lyrics else 0
        if any(len(ls) != n_sents for ls in lyrics):
            raise ValueError("pack_rows needs one sentence count for all samples")
        tlen = n_sents * (max_sent + 2) + 1
        c_topics = (ctypes.c_char_p * max(n, 1))(
            *[t.encode("utf-8") for t in topics])
        c_lyrics = (ctypes.c_char_p * max(n * n_sents, 1))(
            *[s.encode("utf-8") for ls in lyrics for s in ls])
        out = {k: np.zeros((n, w), np.int32) for k, w in (
            ("topic_ids", topic_len), ("tpw_attention_mask", topic_len),
            ("tpw_type_ids", topic_len), ("targets", tlen),
            ("attention_mask", tlen), ("type_ids", tlen))}
        ptr = lambda a: a.ctypes.data_as(_I32P)  # noqa: E731
        rc = self._lib.wp_pack_rows(
            self._h, c_topics, c_lyrics, n, n_sents, topic_len, max_sent,
            pad_id, start_id, eos_id, sep_id,
            *(ptr(out[k]) for k in ("topic_ids", "tpw_attention_mask",
                                    "tpw_type_ids", "targets", "attention_mask",
                                    "type_ids")), 0)
        if rc != 0:
            raise RuntimeError("native pack_rows: invalid handle")
        return out


class NativeBPE:
    """The C++ byte-level BPE encoder of one ``vocab.json`` + ``merges.txt``:
    ids as :class:`mmtg_tpu_torch.bpe.ByteLevelBPETokenizer` gives them. The
    encoder caches words in the handle, so calls are serialised."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib, self._h = lib, handle
        self._call = threading.Lock()
        weakref.finalize(self, lib.bpe_free, handle)

    def encode(self, text: str) -> List[int]:
        """Ids of ``text`` (which must hold no NUL: C strings end there)."""
        with self._call:
            return _ids(self._lib.bpe_encode_ids, self._h, text)


def load_native_tokenizer(vocab_path: str) -> Optional[NativeWordPiece]:
    """The C++ WordPiece tokenizer of ``vocab_path``; ``None`` without a
    compiler (or when the library rejects the file): the Python path."""
    lib = load("wordpiece")
    if lib is None:
        return None
    handle = lib.wp_create(vocab_path.encode("utf-8"))
    return NativeWordPiece(lib, handle) if handle else None


def load_native_bpe(vocab_json: str, merges_txt: str) -> Optional[NativeBPE]:
    """The C++ BPE encoder of the two files; ``None`` without a compiler (or
    when the library rejects the files): the Python path."""
    lib = load("bpe")
    if lib is None:
        return None
    handle = lib.bpe_create(vocab_json.encode("utf-8"), merges_txt.encode("utf-8"))
    return NativeBPE(lib, handle) if handle else None
