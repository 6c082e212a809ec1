"""Data pipeline: pkl samples → packed, device-ready arrays (the port's own
copy of :mod:`mmtg_tpu.data`). The token columns come from one threaded
call of the C++ row packer (``wp_pack_rows``, :mod:`mmtg_tpu_torch.native`)
when the tokenizer's C++ fast path is loaded and the corpus fits the fixed
22-token grid, else from the Python framing below — bit for bit the same.

Reimplements the reference dataset semantics (``MyDataset.py:14-118``) with
a columnar layout: instead of per-item Python assembly feeding a torch
DataLoader, the whole dataset is packed once into contiguous NumPy arrays
(static shapes) so batches are pure slices that transfer to the device
with zero per-step Python work. The reference's per-token
``token_id2emb`` dict lookups (``model.py:253-268``, its CPU hot spot)
become a single dense ``[vocab, wenlan_emb]`` gather table.

Framing contract (SURVEY.md Appendix A):
  * topic prompt: ``"主题词：" + topic`` tokenized, truncated/padded to 15
    (``MyDataset.py:62-78``); mask/type 1 on real tokens.
  * each sentence: ``[#START#]`` + ≤20 content tokens padded to 21 +
    ``[#EOS#]`` = 22 tokens; 10 sentences + final ``[SEP]`` = 221
    (``MyDataset.py:81-118``).
  * type ids (train scheme): sentence pair p∈{0..3} → p+1 on content
    tokens; pair 4 → 1 ("call back"); START/EOS/pad → 0
    (``MyDataset.py:99-109``).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmtg_tpu_torch.configs import DataConfig, SpecialTokens
from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

SPECIAL = SpecialTokens()


# ---------------------------------------------------------------------------
# Framing (host-side, pure python — matches MyDataset.py bit-for-bit)
# ---------------------------------------------------------------------------


def encode_topic(
    tokenizer: WordPieceTokenizer, topic_words: str, cfg: DataConfig
) -> Tuple[List[int], List[int], List[int]]:
    """Tokenize the topic prompt (reference ``MyDataset.py:62-78``)."""
    prompt = "主题词：" + topic_words  # "Topic words: ..."
    ids = tokenizer.encode(prompt)
    n = cfg.topic_prompt_length
    ids = ids[:n]
    mask = [1] * len(ids)
    type_ids = [1] * len(ids)  # same type as the 1st/5th sentence pair
    while len(ids) < n:
        ids.append(tokenizer.pad_token_id)
        mask.append(0)
        type_ids.append(0)
    return ids, mask, type_ids


def _scrub(sent: str) -> str:
    """Whitespace/NBSP scrubbing (reference ``MyDataset.py:94-95``)."""
    for ch in (" ", "\n", "\t", "\r", "\xa0", "　"):
        sent = sent.replace(ch, "")
    return sent


def encode_lyrics(
    tokenizer: WordPieceTokenizer, lyrics: Sequence[str], cfg: DataConfig
) -> Tuple[List[int], List[int], List[int]]:
    """Frame lyric sentences into the 22-token grid
    (reference ``MyDataset.py:81-118``)."""
    start_id = tokenizer.convert_tokens_to_ids("[#START#]")
    eos_id = tokenizer.convert_tokens_to_ids("[#EOS#]")
    all_ids: List[int] = []
    mask: List[int] = []
    type_ids: List[int] = []
    for i in range(0, len(lyrics), 2):  # sentence pairs
        for sent in lyrics[i : i + 2]:
            ids = [start_id]
            mask.append(1)
            type_ids.append(0)
            content = tokenizer.encode(_scrub(sent))[: cfg.max_sent_length]
            ids.extend(content)
            mask += [1] * len(content)
            if i == 8:  # call-back: 5th pair shares type 1 with the 1st
                type_ids += [1] * len(content)
            else:
                type_ids += [i // 2 + 1] * len(content)
            while len(ids) < cfg.max_sent_length + 1:
                ids.append(tokenizer.pad_token_id)
                mask.append(0)
                type_ids.append(0)
            ids.append(eos_id)
            mask.append(1)
            type_ids.append(0)
            all_ids += ids
    all_ids.append(tokenizer.sep_token_id)
    mask.append(1)
    type_ids.append(0)
    return all_ids, mask, type_ids


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

_ARRAY_KEYS = (
    "topic_ids",
    "tpw_attention_mask",
    "tpw_type_ids",
    "topic_emb",
    "img_embs",
    "r_embs",
    "targets",
    "attention_mask",
    "type_ids",
)


class MMTGDataset:
    """Columnar dataset over the reference pkl format.

    Sample dict keys in the pkl (reference ``MyDataset.py:34-44``):
    ``topic``, ``topic_emb``, ``lyrics``, ``rating`` (train only), and per
    step i∈[0,5): ``img_{i}_emb``, ``r_{i}_emb`` (plus raw strings we do
    not consume). ``__getitem__`` returns the same dict-of-ndarrays as the
    reference for API parity; bulk consumers use :meth:`arrays`.
    """

    def __init__(
        self,
        file_path: str,
        tokenizer: WordPieceTokenizer,
        data_config: DataConfig,
        if_train: bool = True,
        seq_len: int = 5,
    ):
        with open(file_path, "rb") as f:
            raw = pickle.load(f)
        self._build(raw, tokenizer, data_config, if_train, seq_len)

    @classmethod
    def from_records(cls, records, tokenizer, data_config, if_train=True, seq_len=5):
        self = cls.__new__(cls)
        self._build(records, tokenizer, data_config, if_train, seq_len)
        return self

    def _build(self, raw, tokenizer, cfg, if_train, seq_len):
        self.if_train = if_train
        self.data_config = cfg
        self.topics = [item["topic"] for item in raw]
        n = len(raw)
        tlen = cfg.target_length
        cols: Dict[str, np.ndarray] = {
            "topic_ids": np.zeros((n, cfg.topic_prompt_length), np.int32),
            "tpw_attention_mask": np.zeros((n, cfg.topic_prompt_length), np.int32),
            "tpw_type_ids": np.zeros((n, cfg.topic_prompt_length), np.int32),
            "topic_emb": np.zeros((n, cfg.wenlan_emb_size), np.float32),
            "img_embs": np.zeros((n, seq_len, cfg.wenlan_emb_size), np.float32),
            "r_embs": np.zeros((n, seq_len, cfg.wenlan_emb_size), np.float32),
            "targets": np.zeros((n, tlen), np.int32),
            "attention_mask": np.zeros((n, tlen), np.int32),
            "type_ids": np.zeros((n, tlen), np.int32),
        }
        if if_train:
            cols["rating"] = np.zeros((n,), np.float32)
        # Test-set rows carry per-step human relevance annotations
        # ``score_0..score_4`` (reference ``README.md:66-78``). The
        # reference code never consumes them; we surface them as a
        # ``scores`` [n, seq_len] side column (NaN where absent) so
        # analysis tooling can correlate generations with the human
        # ratings — ``scores`` is NOT part of the model batch (``batches``
        # and ``_ARRAY_KEYS`` exclude it).
        self.scores = np.full((n, seq_len), np.nan, np.float32)

        # Token columns: one threaded native call when the C++ WordPiece
        # tokenizer is loaded and the corpus matches the reference framing
        # contract (2 sentences a step: the fixed 22-token grid; no NUL,
        # where a C string ends); otherwise the per-sample Python framing.
        native = getattr(tokenizer, "native", None)
        packed = (
            n > 0 and hasattr(native, "pack_rows")
            and all(len(item["lyrics"]) == 2 * seq_len for item in raw)
            and cfg.target_length == 2 * seq_len * (cfg.max_sent_length + 2) + 1
            and not any("\0" in s for item in raw
                        for s in (item["topic"], *item["lyrics"])))
        if packed:
            cols.update(native.pack_rows(
                [item["topic"] for item in raw],
                [list(item["lyrics"]) for item in raw],
                topic_len=cfg.topic_prompt_length,
                max_sent=cfg.max_sent_length,
                pad_id=tokenizer.pad_token_id,
                start_id=tokenizer.convert_tokens_to_ids("[#START#]"),
                eos_id=tokenizer.convert_tokens_to_ids("[#EOS#]"),
                sep_id=tokenizer.sep_token_id))

        for i, item in enumerate(raw):
            for k in range(seq_len):
                if f"score_{k}" in item:
                    self.scores[i, k] = float(item[f"score_{k}"])
            if not packed:
                tids, tmask, ttype = encode_topic(tokenizer, item["topic"], cfg)
                lids, lmask, ltype = encode_lyrics(tokenizer, item["lyrics"], cfg)
                cols["topic_ids"][i] = tids
                cols["tpw_attention_mask"][i] = tmask
                cols["tpw_type_ids"][i] = ttype
                cols["targets"][i] = lids
                cols["attention_mask"][i] = lmask
                cols["type_ids"][i] = ltype
            cols["topic_emb"][i] = np.asarray(item["topic_emb"], np.float32)
            cols["img_embs"][i] = np.stack(
                [np.asarray(item[f"img_{k}_emb"], np.float32) for k in range(seq_len)]
            )
            cols["r_embs"][i] = np.stack(
                [np.asarray(item[f"r_{k}_emb"], np.float32) for k in range(seq_len)]
            )
            if if_train:
                cols["rating"][i] = float(item["rating"])
        self._cols = cols
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self._cols.items()}

    def arrays(self) -> Dict[str, np.ndarray]:
        """The whole dataset as contiguous columnar arrays."""
        return self._cols

    # -- static-shape batching ---------------------------------------------

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        rng: Optional[np.random.Generator] = None,
        drop_remainder: bool = False,
    ):
        """Yield dicts of ``[batch, ...]`` arrays plus a ``sample_mask``.

        Static shapes always: the tail batch is padded by repeating row 0
        and masked via ``sample_mask``, so every step sees one shape.
        """
        order = np.arange(self._n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for lo in range(0, self._n, batch_size):
            idx = order[lo : lo + batch_size]
            valid = len(idx)
            if valid < batch_size:
                if drop_remainder:
                    return
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - valid, dtype=idx.dtype)]
                )
            batch = {k: v[idx] for k, v in self._cols.items()}
            mask = np.zeros((batch_size,), np.float32)
            mask[:valid] = 1.0
            batch["sample_mask"] = mask
            yield batch


# ---------------------------------------------------------------------------
# Token-embedding side table
# ---------------------------------------------------------------------------


def load_token_embedding_table(
    path: str, vocab_size: int, emb_size: int = 2048
) -> np.ndarray:
    """Load ``token_id2emb_dict.pkl`` (dict id→2048-dim list) as one dense
    ``[vocab_size, emb_size]`` float32 array (reference ``model.py:221-223``
    loads the dict; ``model.py:253-268`` loops over it per token — here the
    lookup is a single ``jnp.take``)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    table = np.zeros((vocab_size, emb_size), np.float32)
    for tok_id, emb in d.items():
        table[int(tok_id)] = np.asarray(emb, np.float32)
    return table


# ---------------------------------------------------------------------------
# Synthetic fixtures (tests/benchmarks; reference ships no fixtures)
# ---------------------------------------------------------------------------


def make_synthetic_records(
    n: int,
    rng: np.random.Generator,
    emb_size: int = 2048,
    seq_len: int = 5,
    sentences: int = 10,
    topic: str = "雪山",
    lyrics_pool: Optional[List[str]] = None,
) -> List[dict]:
    """Random records in the reference pkl schema (MyDataset.py:34-44).

    ``lyrics_pool`` overrides the default Chinese sentences — pass English
    lines (and a smaller ``emb_size`` for CLIP) to build English-variant
    fixtures (reference README.md:19-20,86)."""
    records = []
    base_sents = lyrics_pool or [
        "青山一道同云雨", "明月何曾是两乡", "海内存知己", "天涯若比邻"
    ]
    for i in range(n):
        rec = {
            "topic": topic,
            "topic_emb": rng.standard_normal(emb_size).astype(np.float32),
            "lyrics": [base_sents[(i + j) % len(base_sents)] for j in range(sentences)],
            "rating": float(rng.integers(1, 6)),
        }
        for k in range(seq_len):
            rec[f"img_{k}_emb"] = rng.standard_normal(emb_size).astype(np.float32)
            rec[f"r_{k}_emb"] = rng.standard_normal(emb_size).astype(np.float32)
        records.append(rec)
    return records
