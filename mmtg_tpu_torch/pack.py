"""Sequence packing for training (:mod:`mmtg_tpu.pack`): drop PAD tokens,
pack samples into rows. Host-side numpy only.

The reference frames every lyric sentence into a fixed 22-token cell —
``[#START#]`` + ≤20 content tokens padded to 21 + ``[#EOS#]`` — and its loss
keeps the PAD positions. Real sentences are far shorter than 20 tokens, so a
large share of every 236-token row is PAD that costs full decoder work.

``--pack_sequences`` is the EXPLICITLY NON-PARITY training mode that removes
that waste:

  * each sample is *compacted* — topic-prompt pad and intra-frame PAD tokens
    are dropped, every surviving token keeping its ORIGINAL position id
    (wpe), type id, and fused-window index;
  * compacted samples are packed next-fit into rows of a static ``row_len``
    (≤ ``max_slots`` samples per row), with per-token segment ids so
    attention never crosses sample boundaries;
  * the loss becomes a per-sample mean over the sample's REAL label tokens
    instead of the fixed 220-position grid, and each packed batch carries a
    varying number of real samples.

Token-accounting contract (the documented non-parity delta):

  * parity CE denominator: always 220 (PAD-in-loss kept);
  * packed CE denominator: the sample's real label count (``slot_nlabels``)
    — labels are kept target tokens at frame positions 1..220 of the
    ORIGINAL grid;
  * a sample with zero PAD (all sentences exactly 20 content tokens, topic
    mask full) packs to the identical 236-token stream and the two
    objectives coincide exactly (``tests/test_torch_packed_step.py``).

The device-side consumers are
:func:`mmtg_tpu_torch.models.mmtg.mmtg_forward_train_packed` (segment-masked
decoder) and :func:`mmtg_tpu_torch.loss.packed_sequence_unlikelihood_loss`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from mmtg_tpu_torch.configs import DataConfig, SpecialTokens

SPECIAL = SpecialTokens()
NO_WINDOW = 5  # fused-window slot meaning "no fused vector added"


def compact_sample(
    topic_ids: np.ndarray,
    tpw_mask: np.ndarray,
    tpw_type: np.ndarray,
    targets: np.ndarray,
    type_ids: np.ndarray,
    dcfg: DataConfig,
) -> Dict[str, np.ndarray]:
    """One sample → compact per-token arrays (PAD dropped).

    Keeps: topic tokens with ``tpw_attention_mask == 1``, then every
    non-PAD target token. Each kept token carries its original position
    in the 236 grid (topic 0..14, target 15+p), its data-provided type
    id, its fused-window index (``p // 44`` for target positions p < 220,
    ``NO_WINDOW`` otherwise — the reference adds no fused vector to the
    trailing [SEP] or the topic block), and its label/label-weight
    (next kept token; counted when the label is a target token at grid
    position 1..220, the positions the parity loss scores after its
    shift).
    """
    P = dcfg.topic_prompt_length
    keep_t = tpw_mask.astype(bool)
    keep_y = targets != SPECIAL.pad_id
    tok = np.concatenate([topic_ids[keep_t], targets[keep_y]])
    tpos = np.arange(P)[keep_t]
    ypos_grid = np.arange(targets.shape[0])[keep_y]  # target-grid positions
    pos = np.concatenate([tpos, P + ypos_grid])
    typ = np.concatenate([tpw_type[keep_t], type_ids[keep_y]])
    win = np.concatenate(
        [
            np.full(tpos.shape, NO_WINDOW, np.int32),
            np.where(
                ypos_grid < 2 * dcfg.sent_frame_length * 5,
                np.minimum(ypos_grid // dcfg.two_sents_length, 4),
                NO_WINDOW,
            ),
        ]
    )
    # labels: next kept token, scored when that next token sits at
    # target-grid position 1..220 (i.e. any kept target token except the
    # very first, grid position 0 = the opening [#START#])
    n = tok.shape[0]
    label = np.zeros((n,), np.int32)
    label_w = np.zeros((n,), np.float32)
    if n > 1:
        label[:-1] = tok[1:]
        next_is_scored = np.zeros((n,), bool)
        is_scored_target = np.concatenate(
            [np.zeros(tpos.shape, bool), ypos_grid >= 1]
        )
        next_is_scored[:-1] = is_scored_target[1:]
        label_w[next_is_scored] = 1.0
    return {
        "tok": tok.astype(np.int32),
        "pos": pos.astype(np.int32),
        "typ": typ.astype(np.int32),
        "win": win.astype(np.int32),
        "label": label,
        "label_w": label_w,
    }


def synthetic_framed_cols(
    rng: np.random.Generator,
    dcfg: DataConfig,
    content_lens_per_sample,
    emb_size: Optional[int] = None,
    n_windows: int = 5,
    vocab_high: int = 8000,
) -> Dict[str, np.ndarray]:
    """Columnar arrays following ``data.encode_lyrics``' frame grid with
    prescribed per-sentence content lengths — shared by the pack tests and
    ``chip_smoke.py`` so both see the same PAD distribution."""
    E = emb_size or dcfg.wenlan_emb_size
    B = len(content_lens_per_sample)
    P = dcfg.topic_prompt_length
    tl = dcfg.target_length
    ms = dcfg.max_sent_length
    cols = {
        "topic_ids": rng.integers(103, vocab_high, (B, P)).astype(np.int32),
        "tpw_attention_mask": np.ones((B, P), np.int32),
        "tpw_type_ids": np.ones((B, P), np.int32),
        "topic_emb": rng.standard_normal((B, E)).astype(np.float32),
        "img_embs": rng.standard_normal((B, n_windows, E)).astype(np.float32),
        "r_embs": rng.standard_normal((B, n_windows, E)).astype(np.float32),
        "targets": np.zeros((B, tl), np.int32),
        "attention_mask": np.zeros((B, tl), np.int32),
        "type_ids": np.zeros((B, tl), np.int32),
        "rating": rng.integers(1, 6, (B,)).astype(np.float32),
    }
    for i, lens in enumerate(content_lens_per_sample):
        at = 0
        tgt, mask, typ = (cols["targets"][i], cols["attention_mask"][i],
                          cols["type_ids"][i])
        for s, cl in enumerate(lens):
            pair = s // 2
            tid = 1 if pair == 4 else pair + 1
            tgt[at] = SPECIAL.start_id
            mask[at] = 1
            at += 1
            n = int(cl)
            tgt[at:at + n] = rng.integers(103, vocab_high, n)
            mask[at:at + n] = 1
            typ[at:at + n] = tid
            at += ms  # content + PAD slots
            tgt[at] = SPECIAL.eos_id
            mask[at] = 1
            at += 1
        tgt[at] = SPECIAL.sep_id
        mask[at] = 1
    return cols


class PackedBatcher:
    """Pack a columnar dataset's samples into static-shape row batches.

    Greedy NEXT-fit in (shuffled) sample order: a sample joins the
    current row if its compact length fits and a segment slot is free,
    otherwise the current row is closed for good and a new one starts (no
    earlier row is looked at again, so this is next-fit, not first-fit; the
    order is the JAX package's exactly). Yields batches of ``rows`` packed
    rows; the per-batch REAL sample count varies (the loss normalizes by
    it). The tail batch pads with empty rows — ``slot_valid`` masks them.
    """

    def __init__(
        self,
        cols: Dict[str, np.ndarray],
        dcfg: DataConfig,
        row_len: int = 256,
        max_slots: int = 4,
    ):
        self.cols = cols
        self.dcfg = dcfg
        self.row_len = row_len
        self.max_slots = max_slots
        n = cols["targets"].shape[0]
        self.compact = [
            compact_sample(
                cols["topic_ids"][i],
                cols["tpw_attention_mask"][i],
                cols["tpw_type_ids"][i],
                cols["targets"][i],
                cols["type_ids"][i],
                dcfg,
            )
            for i in range(n)
        ]
        too_long = [
            i for i, c in enumerate(self.compact)
            if c["tok"].shape[0] > row_len
        ]
        if too_long:
            raise ValueError(
                f"samples {too_long[:5]} exceed row_len={row_len} "
                f"compact; raise --pack_row_len"
            )
        self.n = n
        self.density = (
            sum(c["tok"].shape[0] for c in self.compact)
            / max(1, n * (dcfg.topic_prompt_length + dcfg.target_length))
        )

    def pack_order(self, order: np.ndarray) -> List[List[int]]:
        rows: List[List[int]] = []
        cur: List[int] = []
        cur_len = 0
        for i in order:
            ln = self.compact[i]["tok"].shape[0]
            if cur and (cur_len + ln > self.row_len
                        or len(cur) >= self.max_slots):
                rows.append(cur)
                cur, cur_len = [], 0
            cur.append(int(i))
            cur_len += ln
        if cur:
            rows.append(cur)
        return rows

    def batches(
        self,
        rows_per_batch: int,
        shuffle: bool = False,
        rng: Optional[np.random.Generator] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        rows = self.pack_order(order)
        R, L, S = rows_per_batch, self.row_len, self.max_slots
        E = self.cols["topic_emb"].shape[1]
        n_img = self.cols["img_embs"].shape[1]
        has_rating = "rating" in self.cols
        for lo in range(0, len(rows), R):
            chunk = rows[lo:lo + R]
            b = {
                "tokens": np.zeros((R, L), np.int32),
                "positions": np.zeros((R, L), np.int32),
                "type_ids": np.zeros((R, L), np.int32),
                "win": np.full((R, L), NO_WINDOW, np.int32),
                "seg": np.full((R, L), S, np.int32),
                "labels": np.zeros((R, L), np.int32),
                "label_w": np.zeros((R, L), np.float32),
                "slot_valid": np.zeros((R, S), np.float32),
                "slot_rating": np.ones((R, S), np.float32),
                "slot_nlabels": np.ones((R, S), np.float32),
                "topic_emb": np.zeros((R, S, E), np.float32),
                "img_embs": np.zeros((R, S, n_img, E), np.float32),
                "r_embs": np.zeros((R, S, n_img, E), np.float32),
            }
            for r, row in enumerate(chunk):
                at = 0
                for s, i in enumerate(row):
                    c = self.compact[i]
                    ln = c["tok"].shape[0]
                    sl = slice(at, at + ln)
                    b["tokens"][r, sl] = c["tok"]
                    b["positions"][r, sl] = c["pos"]
                    b["type_ids"][r, sl] = c["typ"]
                    b["win"][r, sl] = c["win"]
                    b["seg"][r, sl] = s
                    b["labels"][r, sl] = c["label"]
                    b["label_w"][r, sl] = c["label_w"]
                    b["slot_valid"][r, s] = 1.0
                    b["slot_nlabels"][r, s] = max(c["label_w"].sum(), 1.0)
                    if has_rating:
                        b["slot_rating"][r, s] = self.cols["rating"][i]
                    b["topic_emb"][r, s] = self.cols["topic_emb"][i]
                    b["img_embs"][r, s] = self.cols["img_embs"][i]
                    b["r_embs"][r, s] = self.cols["r_embs"][i]
                    at += ln
            yield b
