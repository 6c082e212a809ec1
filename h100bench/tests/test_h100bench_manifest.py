"""``BENCHMARK.json`` against the contract's form, and every piece it names
found as a file of its own."""

import dataclasses
import json
import os
import re

import pytest

from h100bench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["h100bench"]
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] \
                and "\t" not in entry[k]


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_every_config_has_a_cell():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        mine = [m["name"] for m in MAN["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert harness.reported_metrics(MAN, w["name"]), w["name"]


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_file(m):
    """Each per-layer metric has its reader, which agrees with the manifest,
    and each cell it lists reports the end-to-end metric it moves."""
    mod = harness.metric(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
    moved = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
    for w in m["workloads"]:
        assert w in moved.get("workloads", [w])
    if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
        assert m["unit"] == "%"


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    assert w["chips"] in (1, 4)
    cfg = harness.config(w["config"])
    tr = harness.traffic(w["traffic"])
    lim = harness.limits(w["name"])
    assert os.path.exists(os.path.join(harness.BENCH, "drivers",
                                       tr["kind"] + ".py"))
    assert {"outside_share", "frame_mismatches"} <= set(lim) if tr["kind"] == "generate" \
        else {"loss", "grad", "change", "grad_median", "change_median"} <= set(lim)
    harness.model_configs(cfg)


def test_config_files_are_the_published_configurations():
    """``mmtg_zh`` is the program's default configuration and ``mmtg_en``
    its English variant, key for key; nothing is reduced."""
    from mmtg_tpu_torch.configs import DataConfig, ModelConfig, english_variant

    want = {"mmtg_zh": (ModelConfig(), DataConfig()),
            "mmtg_en": english_variant()}
    for c in MAN["configs"]:
        cfg = harness.config(c["name"])
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"] == []
        assert c["source"] == cfg["source"]
        mcfg, dcfg = want[c["name"]]
        assert cfg["model"] == dataclasses.asdict(mcfg)
        assert cfg["data"] == dataclasses.asdict(dcfg)
