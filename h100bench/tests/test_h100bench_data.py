"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are added as files of their own: the harness finds them by name, and no
file already there is edited."""

import hashlib
import json
import os
import shutil

from h100bench import harness


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_from_files(tmp_path):
    bench = str(tmp_path / "h100bench")
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(bench)
    cfg = harness.config("mmtg_zh", bench)
    cfg["model"]["gpt2"]["n_layer"] = 6
    cfg["reduced"] = ["gpt2"]
    files = {
        "configs/mmtg_zh_l6.json": cfg,
        "traffic/generate-b1024.json": dict(harness.traffic("generate-b2048",
                                                            bench), batch=1024),
        "limits/zh6-generate-b1024.json": {"outside_share": 0.1, "frame_mismatches": 0},
    }
    for rel, obj in files.items():
        with open(os.path.join(bench, rel), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(bench, "metrics", "generate.calls.py"), "w") as f:
        f.write('UNIT = "count"\nLAYER = "decoding.py host loop"\n'
                'MOVES = "generate_tok_s"\n\n\ndef read(record):\n'
                '    return record.attempted / record.path["batch"]\n')
    man = harness.manifest()
    man["workloads"].append({"name": "zh6-generate-b1024", "config": "mmtg_zh_l6",
                             "traffic": "generate-b1024", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "generate.calls", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "decoding.py host loop",
                             "moves": "generate_tok_s"})
    for m in man["end_to_end"]:
        if m["name"] == "generate_tok_s":
            m["workloads"].append("zh6-generate-b1024")
    ctx = harness.context("zh6-generate-b1024", 1, 1.0, False, None, 0.0, man,
                          bench=bench)
    assert ctx.traffic["batch"] == 1024 and ctx.traffic["kind"] == "generate"
    mcfg, _ = harness.model_configs(ctx.config)
    assert mcfg.gpt2.n_layer == 6
    assert ctx.limits["outside_share"] == 0.1
    assert harness.driver(ctx.traffic["kind"], bench).run
    names = [m["name"] for m in harness.reported_metrics(man, "zh6-generate-b1024")]
    assert "generate.calls" in names
    rec = harness.Record(1.0, {}, 2048, 0, 0, {}, True, {"batch": 1024})
    assert harness.metric("generate.calls", bench).read(rec) == 2.0
    after = _digest(bench)
    assert {k: after[k] for k in before} == before
