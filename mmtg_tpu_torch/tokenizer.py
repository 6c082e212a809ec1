"""BERT-style WordPiece tokenizer (the port's own copy of
:mod:`mmtg_tpu.tokenizer`): pure Python, with the C++ tokenizer of
``native/wordpiece.cc`` (:mod:`mmtg_tpu_torch.native`) as its fast path for
``encode`` when a compiler is present — the same ids either way.

Drop-in replacement for the HF ``BertTokenizer`` the reference loads from
``vocab.txt`` (reference ``train.py:65``, ``generate.py:185``) — no HF
dependency on the hot path. Implements the same pipeline: text cleanup,
CJK-character isolation, lowercasing + accent stripping, punctuation
splitting, then greedy longest-match WordPiece with ``##`` continuations.

Special ids are pinned by the MMTG vocab layout: PAD=0, [#START#]=1,
[#EOS#]=2, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103 (vocab.txt lines
1-3 and 101-104; see SURVEY.md Appendix A).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation by BERT even when unicode says
    # otherwise (e.g. '$', '`').
    if (
        (33 <= cp <= 47)
        or (58 <= cp <= 64)
        or (91 <= cp <= 96)
        or (123 <= cp <= 126)
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class WordPieceTokenizer:
    """BERT-compatible tokenizer over a newline-delimited vocab file."""

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        pad_token: str = "[PAD]",
        sep_token: str = "[SEP]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.pad_token = pad_token
        self.sep_token = sep_token
        self.max_input_chars_per_word = max_input_chars_per_word

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_file(cls, vocab_path: str, use_native: bool = True,
                  **kw) -> "WordPieceTokenizer":
        """``use_native`` loads the C++ tokenizer of the same file as the
        fast path (``None`` without a compiler: the Python path)."""
        vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for idx, line in enumerate(f):
                token = line.rstrip("\n")
                if token:
                    vocab[token] = idx
        tk = cls(vocab, **kw)
        if use_native:
            from mmtg_tpu_torch.native import load_native_tokenizer

            tk.native = load_native_tokenizer(vocab_path)
        return tk

    # -- fast encode (native when loaded) ----------------------------------

    native = None  # a mmtg_tpu_torch.native.NativeWordPiece, set by from_file

    def encode(self, text: str) -> List[int]:
        """``convert_tokens_to_ids(tokenize(text))``, through the C++
        tokenizer when it is loaded (and the text holds no NUL, where a C
        string would end)."""
        if self.native is not None and "\0" not in text:
            return self.native.tokenize_to_ids(text)
        return self.convert_tokens_to_ids(self.tokenize(text))

    # -- id helpers (HF-compatible surface) --------------------------------

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

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        if isinstance(ids, int):
            return self.ids_to_tokens.get(ids, self.unk_token)
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    # -- tokenization pipeline ---------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic_tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_cjk_chars(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_on_punc(tok))
        return " ".join(tokens).split()

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_cjk_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text: str) -> List[str]:
        chunks: List[List[str]] = []
        start_new = True
        for ch in text:
            if _is_punctuation(ch):
                chunks.append([ch])
                start_new = True
            else:
                if start_new:
                    chunks.append([])
                start_new = False
                chunks[-1].append(ch)
        return ["".join(c) for c in chunks]

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            tokens.append(piece)
            start = end
        return tokens
