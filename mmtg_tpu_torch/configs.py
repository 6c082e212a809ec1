"""Frozen configuration dataclasses (the port's own copy of
:mod:`mmtg_tpu.configs`: same field names and defaults).

Mirrors the reference's three config tiers (reference ``configs.py:14-41``
``model_cfgs`` dict, ``configs.py:43-54`` ``data_config`` class, and
``config/model_config.json``) as typed frozen dataclasses with identical
keys and defaults, so a reference user finds every knob in the same place.
No ``eval`` parsing anywhere (reference ``train.py:54`` quirk dropped).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """One encoder channel (reference ``configs.py:16-31``)."""

    input_dim: int = 2048
    hidden_dim: int = 512
    # 'RNN' | 'LSTM' | 'GRU'. The reference mentions 'TRM' in a comment
    # (configs.py:10) but never implements it; we implement it for real
    # (a small transformer channel) as a capability superset.
    type: str = "GRU"
    num_layers: int = 1


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Decoder transformer config (reference ``config/model_config.json``).

    Matches HF ``GPT2Config`` semantics for the fields the reference uses:
    learned position embeddings, token-type ids embedded with the *word*
    embedding matrix, weight-tied LM head, gelu_new activation.
    """

    vocab_size: int = 13317
    n_positions: int = 1024
    n_ctx: int = 250
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    # HF defaults the reference inherits (not in the JSON):
    resid_pdrop: float = 0.1
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def from_json_file(cls, path: str) -> "GPT2Config":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level model config (reference ``configs.py:14-41``)."""

    seq_len: int = 5  # 10 lyric sentences = seq_len * 2
    topic: ChannelConfig = dataclasses.field(
        default_factory=lambda: ChannelConfig(type="MLP")
    )
    image: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    text: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    # SELF_ATT (alpha attention) — reference configs.py:32-35
    self_att_hidden_size: int = 512
    self_att_heads: int = 4
    # MM_ATT (beta attention) — reference configs.py:36-38
    mm_att_dim: int = 1
    mm_att_out_dim: int = 2048  # hardcoded at reference model.py:179
    gpt2_path: str = "./pretrained/GPT2_lyrics_ckpt_epoch00.ckpt"
    dropout: float = 0.1
    gpt2: GPT2Config = dataclasses.field(default_factory=GPT2Config)

    def __post_init__(self):
        if self.topic.hidden_dim != self.image.hidden_dim or (
            self.image.hidden_dim != self.text.hidden_dim
        ):
            # reference model.py:36-37 enforces the same invariant
            raise ValueError(
                "The hidden dim of topic, image and text must be equal."
            )
        if self.self_att_hidden_size % self.self_att_heads != 0:
            # reference model.py:104-105
            raise ValueError(
                f"The hidden size ({self.self_att_hidden_size}) is not a "
                f"multiple of the number of attention heads "
                f"({self.self_att_heads})"
            )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data layout config (reference ``configs.py:43-54``)."""

    topic_prompt_length: int = 15
    max_sent_length: int = 20
    max_seq_length: int = 220
    wenlan_emb_size: int = 2048

    # Derived layout constants (reference model.py:250, MyDataset.py:103-114)
    @property
    def sent_frame_length(self) -> int:
        """[#START#] + max_sent_length content slots + [#EOS#] = 22."""
        return self.max_sent_length + 2

    @property
    def two_sents_length(self) -> int:
        """One experience step covers 2 sentences = 44 tokens."""
        return self.sent_frame_length * 2

    @property
    def target_length(self) -> int:
        """10 framed sentences + trailing [SEP] = 221."""
        return self.max_seq_length + 1

    def __getitem__(self, key: str):
        # dict-style access kept for reference-API parity (configs.py:50-54)
        return getattr(self, key)


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Special token ids pinned by ``vocab.txt`` (lines 1-3, 101-104)."""

    pad_id: int = 0
    start_id: int = 1  # [#START#]
    eos_id: int = 2  # [#EOS#]
    unk_id: int = 100  # [UNK]
    cls_id: int = 101  # [CLS]
    sep_id: int = 102  # [SEP]
    mask_id: int = 103  # [MASK]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer config — flag names/defaults match reference ``train.py:33-51``."""

    batch_size: int = 32
    val_batch_size: int = 32
    epochs: int = 5
    lr: float = 1e-5
    curriculums: Tuple[int, int] = (1, 3)
    seed: int = 42
    log_interval: int = 100
    val_interval_ratio: float = 0.2
    alpha: float = 0.0  # KL weight; train.sh uses 0.2
    grad_clip_norm: float = 1.0  # train.py:194
    warmup_epoch_ratio: float = 0.1  # train.py:147
    # transformers.AdamW defaults the reference uses (train.py:137):
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-6
    weight_decay: float = 0.0
    # Extras absent in the reference:
    dtype: str = "float32"  # compute dtype; 'bfloat16' keeps f32 masters
    remat: bool = True  # recompute each GPT-2 block in the backward
    mesh_shape: Tuple[int, int] = (1, 1)  # (data, model); the CLI reads --mesh_*
    # Train attention: "auto" / "kernel" = the hand-written kernels on the
    # standard slab (ops/train_attention.py: mha_train_packed, or
    # mha_train_packed_seg on packed rows; CPU tensors take the plain
    # versions), "kernel_padded" = mha_train on the head-major slab with
    # heads padded to 128 lanes (the JAX package's "pallas"), "plain" = the
    # plain version on any device.
    attn_impl: str = "auto"
    # What a block keeps for its backward under remat (models/gpt2.py:
    # REMAT_POLICIES): "full" (its input only), "save_qkv_ctx",
    # "save_ctx_fc1", "save_all"; "auto" = "save_qkv_ctx" when qkv + ctx fit
    # the 5e9-byte gate, else "full" (train._resolve_remat_policy).
    remat_policy: str = "auto"
    # Gradient accumulation: split each batch into N sequential
    # micro-chunks, one fwd+bwd per chunk, exact recombination under the
    # curriculum weighting (each chunk's weighted-mean total is re-scaled
    # by its kept count, summed, divided by the global kept count — see
    # make_train_step).
    grad_accum: int = 1
    # "chunked": CE from hidden states, [B,chunk,V] logits at a time under
    # torch.utils.checkpoint (loss.sequence_unlikelihood_loss_from_hidden)
    # — the same value without the full [B,T,V] logits. "full": the
    # reference-shaped logits path. "auto" picks by the materialized-logits
    # estimate 6·B·T·V bytes (train._resolve_loss_impl).
    loss_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Decode config — defaults match reference ``generate.py:150-165``."""

    batch_size: int = 32
    seed: int = 42
    temperature: float = 1.1
    top_k: int = 10
    top_p: float = 0.7
    repetition_penalty: float = 1.5
    n_samples: int = 10
    length: int = 220  # = data.max_seq_length (generate.py:179)
    # 'train' reproduces the type-id scheme the checkpoint was trained under
    # (MyDataset.py:99-109); 'reference_infer' reproduces the divergent
    # per-sentence scheme the reference rebuilds at inference
    # (model.py:296-306). See SURVEY.md §3.3 for the inconsistency.
    type_id_scheme: str = "train"
    # Decode attention: 'auto' | 'pallas' | 'xla' all mean the per-layer
    # path (the JAX package's names, kept for flag parity: the port attends
    # through its CUDA kernel for CUDA tensors and through the plain version
    # for CPU tensors); 'fused' runs all layers of a step in the whole-step
    # kernel (ops/decode_megakernel) where its scope holds — int8 split
    # cache, full-precision weights — and the per-layer path elsewhere
    # (decoding.resolve_attn_impl).
    attn_impl: str = "auto"
    # KV cache precision: 'model' (= param dtype, reference-exact
    # numerics), 'int8' (per-row abs-max quantization — halves the decode
    # loop's cache traffic at a small sampling-distribution perturbation),
    # 'int4' (two codes a byte, a quarter of the bf16 traffic, a coarser
    # perturbation), or 'auto' (decoding.resolve_cache_dtype: 'int8' at
    # decode batch >= 2, 'model' at batch 1). The CLIs default to 'auto',
    # the library default stays 'model'.
    cache_dtype: str = "model"
    # Merged k||v cache storage: k and v of the int8 cache in one
    # [L, B, T, 2D] buffer, built once after the prefill; bit-identical to
    # the split layout. Int8 per-layer path only (ignored elsewhere, as in
    # the JAX package).
    merged_kv: bool = False
    # top-k implementation: 'exact' (reference semantics); 'approx' takes
    # the exact top-k too (lax.approx_max_k off the TPU).
    topk_impl: str = "exact"
    # Decode-matmul weight precision: 'auto' | 'model' | 'int8'
    # (weight-only per-output-channel quantization,
    # gpt2.quantize_decode_weights; prefill and the embedding gathers keep
    # full precision). 'auto' resolves per decode batch
    # (decoding.resolve_weight_dtype): int8 for B <= 32, 'model' above.
    weight_dtype: str = "auto"
    # Layer-loop unroll factor of the JAX decode step; the port's eager
    # loop ignores it (math-identical at any value).
    layer_unroll: str = "auto"


def english_variant(
    clip_dim: int = 512, gpt2_vocab: int = 50257
) -> Tuple[ModelConfig, DataConfig]:
    """The English adaptation the reference README frames as supported
    (``README.md:19-20``, ``:86``): CLIP embeddings replace WenLan and an
    English GPT-2 replaces the Chinese one. Everything downstream is
    dimension-driven, so this is just a config preset.

    Returns (model_config, data_config)."""
    mcfg = ModelConfig(
        topic=ChannelConfig(input_dim=clip_dim, hidden_dim=512, type="MLP"),
        image=ChannelConfig(input_dim=clip_dim, hidden_dim=512),
        text=ChannelConfig(input_dim=clip_dim, hidden_dim=512),
        mm_att_out_dim=clip_dim,
        gpt2=GPT2Config(vocab_size=gpt2_vocab, n_positions=1024),
    )
    dcfg = DataConfig(wenlan_emb_size=clip_dim)
    return mcfg, dcfg
