"""Host packing throughput of the port (``tools/bench_pack.py`` of the JAX
package): the native C++ packer against the pure-Python framing.

The reference's dataset assembles every sample in Python per
``__getitem__`` (``MyDataset.py:34-60``, again every epoch); the port frames
once, and ``wp_pack_rows`` (``native/wordpiece.cc`` through
``mmtg_tpu_torch/native.py``) moves that one-time framing (1 topic + 10
sentence tokenizations a sample) into threaded C++. This tool times, on a
synthetic corpus, the Python framing with the Python tokenizer, the Python
framing driving the native tokenizer ("hybrid") and the native packer. A
host tool: nothing runs on a device. Without a C++ compiler the native
fields are null.

    python -m mmtg_tpu_torch.tools.bench_pack [n_samples]   # one JSON line
"""

from __future__ import annotations

import json
import os
import sys
import time

SENTS = [
    "青山一道同云雨",
    "明月何曾是两乡",
    "海内存知己天涯若比邻",
    "长风破浪会有时直挂云帆济沧海",
    "会当凌绝顶一览众山小",
    "不畏浮云遮望眼",
    "欲穷千里目更上一层楼",
    "山重水复疑无路柳暗花明又一村",
]

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                     "vocab", "vocab.txt")


def run(n: int = 20000, vocab: str = VOCAB) -> dict:
    """Time the three paths over ``n`` samples; print and return the JSON
    line."""
    from mmtg_tpu_torch.configs import DataConfig
    from mmtg_tpu_torch.data import encode_lyrics, encode_topic
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    tok_py = WordPieceTokenizer.from_file(vocab, use_native=False)
    tok_nat = WordPieceTokenizer.from_file(vocab, use_native=True)
    cfg = DataConfig()

    topics = [f"主题{SENTS[i % len(SENTS)][:4]}{i}" for i in range(n)]
    lyrics = [[SENTS[(i + j) % len(SENTS)] for j in range(10)] for i in range(n)]

    t0 = time.perf_counter()
    for i in range(n):
        encode_topic(tok_py, topics[i], cfg)
        encode_lyrics(tok_py, lyrics[i], cfg)
    t_python = time.perf_counter() - t0

    have_native = tok_nat.native is not None and hasattr(tok_nat.native, "pack_rows")
    # middle point: the Python framing driving the native tokenizer per
    # sentence — isolates what moving the framing itself into C++ buys on
    # top of the native tokenizer
    t_hybrid = None
    if tok_nat.native is not None:
        t0 = time.perf_counter()
        for i in range(n):
            encode_topic(tok_nat, topics[i], cfg)
            encode_lyrics(tok_nat, lyrics[i], cfg)
        t_hybrid = time.perf_counter() - t0
    t_native = None
    if have_native:
        t0 = time.perf_counter()
        out = tok_nat.native.pack_rows(
            topics, lyrics,
            topic_len=cfg.topic_prompt_length,
            max_sent=cfg.max_sent_length,
            pad_id=tok_nat.pad_token_id,
            start_id=tok_nat.convert_tokens_to_ids("[#START#]"),
            eos_id=tok_nat.convert_tokens_to_ids("[#EOS#]"),
            sep_id=tok_nat.sep_token_id,
        )
        t_native = time.perf_counter() - t0
        assert out["targets"].shape == (n, cfg.target_length)

    line = {
        "metric": "dataset token-column packing",
        "n_samples": n,
        "python_s": round(t_python, 3),
        "python_samples_s": round(n / t_python, 1),
        "hybrid_native_tok_s": round(t_hybrid, 3) if t_hybrid else None,
        "hybrid_samples_s": round(n / t_hybrid, 1) if t_hybrid else None,
        "native_s": round(t_native, 3) if t_native else None,
        "native_samples_s": round(n / t_native, 1) if t_native else None,
        "speedup": round(t_python / t_native, 1) if t_native else None,
    }
    print(json.dumps(line))
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    run(int(argv[0]) if argv else 20000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
