"""Byte-level BPE tokenizer (GPT-2 style) for the English variant (the
port's own copy of :mod:`mmtg_tpu.bpe`): pure Python, with the C++ encoder
of ``native/bpe.cc`` (:mod:`mmtg_tpu_torch.native`) as its fast path for
``encode`` when a compiler is present — the same ids either way.

The reference frames English adaptation as supported (reference
``README.md:19-20``, ``:86``): CLIP embeddings + an English GPT-2. An
English GPT-2 tokenizes with **byte-level BPE** (byte→unicode alphabet,
greedy merge ranks, GPT-2's pre-tokenization regex) — the WordPiece
pipeline in ``mmtg_tpu_torch/tokenizer.py`` cannot produce ids for it. This
module implements the public GPT-2 BPE algorithm from scratch:

  * :func:`bytes_to_unicode` — the reversible byte↔unicode alphabet;
  * :func:`pretokenize` — GPT-2's pre-tokenization split, implemented as
    a hand-written scanner (no ``regex`` dependency) with the exact
    leftmost-alternation semantics of the pattern
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``;
  * :class:`ByteLevelBPETokenizer` — encode/decode over ``vocab.json`` +
    ``merges.txt`` (the HF ``GPT2Tokenizer`` file format, so any
    published English GPT-2 vocab drops in, and our trained fixtures
    load into HF for the oracle parity test);
  * :func:`train_bpe` — reference BPE trainer for synthetic-corpus
    fixtures and custom English corpora.

API surface mirrors :class:`mmtg_tpu_torch.tokenizer.WordPieceTokenizer`
(``encode`` / ``pad_token_id`` / ``sep_token_id`` /
``convert_tokens_to_ids``), so ``MMTGDataset`` and the decode framing
work unchanged. Trained vocabs PIN the MMTG special ids (PAD=0,
[#START#]=1, [#EOS#]=2, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103 —
SURVEY.md Appendix A) so ``SpecialTokens()`` defaults, the sampling ban
list and the 22-token frame are vocab-independent.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# The MMTG special-token layout (vocab.txt lines 1-3 and 101-104).
MMTG_SPECIALS = {
    "[PAD]": 0,
    "[#START#]": 1,
    "[#EOS#]": 2,
    "[UNK]": 100,
    "[CLS]": 101,
    "[SEP]": 102,
    "[MASK]": 103,
}


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte→unicode bijection: printable bytes map to
    themselves; the rest shift into U+0100.. so every byte has a visible,
    non-whitespace stand-in (the BPE alphabet)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _cat(ch: str) -> str:
    return unicodedata.category(ch)


def _is_letter(ch: str) -> bool:
    return _cat(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return _cat(ch).startswith("N")


def _is_space(ch: str) -> bool:
    # \s under the `regex` module: ASCII whitespace + Unicode White_Space.
    return ch.isspace()


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def pretokenize(text: str) -> List[str]:
    """GPT-2 pre-tokenization: split ``text`` exactly as the reference
    pattern does (leftmost alternation, greedy quantifiers), without a
    ``\\p{..}``-capable regex engine.

    Alternatives in order: contractions; `` ?\\p{L}+``; `` ?\\p{N}+``;
    `` ?[^\\s\\p{L}\\p{N}]+``; ``\\s+(?!\\S)``; ``\\s+``.
    """
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        # 1) contractions (case-sensitive, as in GPT-2's pattern)
        if ch == "'":
            for c in _CONTRACTIONS:
                if text.startswith(c, i):
                    out.append(c)
                    i += len(c)
                    break
            else:
                c = None
            if c is not None:
                continue
        # optional single leading space shared by alternatives 2-4
        j = i + 1 if ch == " " and i + 1 < n else i
        nxt = text[j]
        if _is_letter(nxt):
            k = j
            while k < n and _is_letter(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if _is_number(nxt):
            k = j
            while k < n and _is_number(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if not _is_space(nxt):
            k = j
            while k < n and not (
                _is_space(text[k]) or _is_letter(text[k]) or _is_number(text[k])
            ):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # whitespace run (ch itself is whitespace and no word follows a
        # single leading space — alternatives 5/6)
        k = i
        while k < n and _is_space(text[k]):
            k += 1
        if k < n and k - i > 1:
            # \s+(?!\S): give the last whitespace char back so it can
            # prefix the following word token
            out.append(text[i : k - 1])
            i = k - 1
        else:
            # run reaches end of string, or single non-' ' whitespace
            # before a word: plain \s+
            out.append(text[i:k])
            i = k
    return out


def get_pairs(word: Sequence[str]) -> set:
    return {(word[k], word[k + 1]) for k in range(len(word) - 1)}


class ByteLevelBPETokenizer:
    """GPT-2-compatible byte-level BPE encoder/decoder.

    ``vocab`` maps token string → id (the ``vocab.json`` dict);
    ``merges`` is the ordered merge list (``merges.txt`` lines).
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        unk_token: str = "[UNK]",
        pad_token: str = "[PAD]",
        sep_token: str = "[SEP]",
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.bpe_ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.unk_token = unk_token
        self.pad_token = pad_token
        self.sep_token = sep_token
        self._cache: Dict[str, List[str]] = {}

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str,
                   use_native: bool = True, **kw):
        """``use_native`` loads the C++ encoder of the same files as the
        fast path (``None`` without a compiler: the Python path)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#version"):
                    continue
                parts = line.rstrip("\n").split(" ")
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        tk = cls(vocab, merges, **kw)
        if use_native:
            from mmtg_tpu_torch.native import load_native_bpe

            tk.native = load_native_bpe(vocab_json, merges_txt)
        return tk

    @classmethod
    def from_dir(cls, path: str, **kw):
        """Load ``<path>/vocab.json`` + ``<path>/merges.txt``."""
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw
        )

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in merges:
                f.write(f"{a} {b}\n")

    # -- BPE ---------------------------------------------------------------

    def bpe(self, token: str) -> List[str]:
        """Apply merges (lowest rank first) to one pre-token's
        byte-unicode string."""
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        if len(word) == 1:
            self._cache[token] = [token]
            return [token]
        pairs = get_pairs(word)
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            k = 0
            while k < len(word):
                if (
                    k < len(word) - 1
                    and word[k] == first
                    and word[k + 1] == second
                ):
                    new_word.append(first + second)
                    k += 2
                else:
                    new_word.append(word[k])
                    k += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    # -- encode / decode ---------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for pre in pretokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in pre.encode("utf-8"))
            tokens.extend(self.bpe(mapped))
        return tokens

    native = None  # a mmtg_tpu_torch.native.NativeBPE, set by from_files

    def encode(self, text: str) -> List[int]:
        """Text → ids, through the C++ encoder when it is loaded (and the
        text holds no NUL, where a C string would end)."""
        if self.native is not None and "\0" not in text:
            return self.native.encode(text)
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        specials = set(MMTG_SPECIALS) | {"<|endoftext|>"}
        chunks: List[str] = []
        for i in ids:
            tok = self.ids_to_tokens.get(int(i), self.unk_token)
            if skip_special_tokens and tok in specials:
                continue
            chunks.append(tok)
        text = "".join(chunks)
        data = bytes(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    # -- HF-compatible surface (mirrors WordPieceTokenizer) ----------------

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    @property
    def unk_token_id(self) -> int:
        return self.vocab[self.unk_token]

    def __len__(self) -> int:
        return len(self.vocab)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.vocab.get(self.unk_token, 0))
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.ids_to_tokens.get(ids, self.unk_token)
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_bpe(
    texts: Iterable[str],
    vocab_size: int,
    specials: Optional[Dict[str, int]] = None,
) -> ByteLevelBPETokenizer:
    """Train a byte-level BPE vocab of ``vocab_size`` tokens over
    ``texts`` (classic pair-frequency merging over pre-tokenized words).

    Layout: special tokens keep their PINNED ids (default
    :data:`MMTG_SPECIALS`, so the MMTG framing/ban tables work on any
    trained vocab); the 256 byte symbols and then the merge products fill
    the remaining id space in order. Ties in pair frequency break by pair
    order (deterministic).
    """
    specials = MMTG_SPECIALS if specials is None else specials
    byte_enc = bytes_to_unicode()
    alphabet = [byte_enc[b] for b in range(256)]

    # word (as symbol tuple) -> count
    word_counts: Counter = Counter()
    for text in texts:
        for pre in pretokenize(text):
            mapped = tuple(byte_enc[b] for b in pre.encode("utf-8"))
            word_counts[mapped] += 1

    n_slots = vocab_size - len(specials) - len(alphabet)
    if n_slots < 0:
        raise ValueError(
            f"vocab_size {vocab_size} < specials+alphabet "
            f"({len(specials) + len(alphabet)})"
        )

    merges: List[Tuple[str, str]] = []
    words = dict(word_counts)
    for _ in range(n_slots):
        pair_counts: Counter = Counter()
        for word, cnt in words.items():
            for k in range(len(word) - 1):
                pair_counts[(word[k], word[k + 1])] += cnt
        if not pair_counts:
            break
        best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        first, second = best
        merged = first + second
        new_words = {}
        for word, cnt in words.items():
            if first not in word:
                new_words[word] = cnt
                continue
            new_word: List[str] = []
            k = 0
            while k < len(word):
                if k < len(word) - 1 and word[k] == first and word[k + 1] == second:
                    new_word.append(merged)
                    k += 2
                else:
                    new_word.append(word[k])
                    k += 1
            new_words[tuple(new_word)] = cnt
        words = new_words

    # assemble the vocab: specials pinned, everything else fills the gaps
    vocab: Dict[str, int] = dict(specials)
    reserved = set(specials.values())
    next_id = 0

    def alloc() -> int:
        nonlocal next_id
        while next_id in reserved:
            next_id += 1
        i = next_id
        next_id += 1
        return i

    for sym in alphabet:
        vocab[sym] = alloc()
    for a, b in merges:
        vocab[a + b] = alloc()
    return ByteLevelBPETokenizer(vocab, merges)


def load_tokenizer(path: str, **kw):
    """Polymorphic loader: a ``vocab.txt`` file → WordPiece (Chinese
    pipeline); a directory with ``vocab.json``+``merges.txt`` → byte-level
    BPE (English pipeline). CLIs route through this so ``--vocab_path``
    covers both variants."""
    if os.path.isdir(path):
        return ByteLevelBPETokenizer.from_dir(path, **kw)
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.from_file(path, **kw)
