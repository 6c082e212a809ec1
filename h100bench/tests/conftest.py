"""Fixtures of the benchmark's own tests: a copy of the benchmark with a
tiny configuration in place of every cell's, runnable on the CPU."""

import json
import os
import shutil

import pytest

from h100bench import harness

TINY_SEED = 2 ** 40 + 7


def tiny_copy(tmp) -> tuple:
    """``(bench, manifest)``: the benchmark copied under ``tmp``, every
    cell's configuration replaced by a 2-layer, 64-wide one (vocab 300,
    32-d table) and every batch cut to 4 rows, in float32, with the int8
    cache and full-precision weights that ``auto`` gives the real batch.
    The limits are the tiny model's own: the float32 program on the CPU
    reads a sampling margin of 0 and training gaps of about 1e-7 against
    the reference; the control (int8 weights, int4 cache) reads margins of
    4.5e-4 to 1.4e-3 (three seeds)."""
    bench = os.path.join(tmp, "h100bench")
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.config("mmtg_zh", bench)
    m = cfg["model"]
    m["gpt2"].update(n_layer=2, n_embd=64, n_head=4, vocab_size=300,
                     n_positions=256)
    for ch in ("topic", "image", "text"):
        m[ch].update(input_dim=32, hidden_dim=16)
    m.update(self_att_hidden_size=16, mm_att_out_dim=32)
    cfg["data"]["wenlan_emb_size"] = 32
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    man = harness.manifest()
    man["workloads"] = [dict(w, config="tiny") for w in man["workloads"]]
    for w in man["workloads"]:
        path = os.path.join(bench, "traffic", w["traffic"] + ".json")
        t = harness.traffic(w["traffic"], bench)
        t.update(batch=4, dtype="float32", check_rows=4, check_block=2)
        lim = {"loss": 1e-5, "grad": 1e-4, "change": 1e-2}
        if t["kind"] == "train":
            t["pool"] = 4
        else:
            t.update(cache_dtype="int8", weight_dtype="model")
            lim = {"margin": 1e-4, "frame_mismatches": 0}
        with open(path, "w") as f:
            json.dump(t, f)
        with open(os.path.join(bench, "limits", w["name"] + ".json"), "w") as f:
            json.dump(lim, f)
    return bench, man


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("tiny")))
