"""The manifest against the benchmark's contract, and the data-driven
layout: a cell, a configuration or a metric is added by files and
manifest entries alone."""
import json
import re

import pytest

from perfbench import harness
from perfbench.tests.conftest import (REPO, TINY_GQA, TINY_TRAFFIC,
                                      make_root)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest(REPO)


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert manifest["paths"] == ["perfbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in manifest[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in manifest["end_to_end"]} >= {"setup_s"}
    for x in manifest["configs"] + manifest["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_every_file_the_manifest_names_is_there(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg
        assert "logits_err_median" in cfg["limits"]
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4)
        tr = json.loads((REPO / "perfbench" / "workloads"
                         / f"{w['traffic']}.json").read_text())
        assert (REPO / "perfbench" / "kinds" / f"{tr['kind']}.py").exists()
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
    for cell in cells:          # every cell reports set-up, another
        reported = {m["name"] for m in harness.cell_metrics(  # end-to-end
            manifest, cell, False)}                    # metric and a layer
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.cell_metrics(manifest, cell, True)
        assert layer and {m["moves"] for m in layer} <= reported


def test_a_cell_config_and_metric_added_by_files(tmp_path):
    """A new configuration, traffic file and per-layer metric reader,
    with their manifest entries, run without a line of code edited."""
    cfg = dict(TINY_GQA, num_hidden_layers=1,
               limits={"logits_err_median": 0.1})
    tr = dict(TINY_TRAFFIC, batch=1, prompt_len=64, agent="baseline")
    root = make_root(tmp_path, {"added_cfg": cfg}, {"added.mix": tr},
                     [("added_cfg.added.mix", "added_cfg", "added.mix")])
    (root / "perfbench" / "metrics" / "prefills_traced.py").write_text(
        "def read(rec):\n    return rec.trace.prefills if rec.trace else "
        "None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append({
        "name": "prefills_traced", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "model step",
        "moves": "prefill_tok_s", "workloads": ["added_cfg.added.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    res = harness.run("added_cfg.added.mix", SEED, 0.3, True, device="cpu",
                      root=root)
    assert res["correct"] is True
    assert res["metrics"]["prefills_traced"]["value"] == tr["trace_prefills"]
    assert harness.run("added_cfg.added.mix", SEED, 0.3, False,
                       device="cpu", root=root)["metrics"]["setup_s"]


def test_unknown_workload_is_refused(tiny_root):
    with pytest.raises(SystemExit, match="no workload"):
        harness.run("nope", SEED, 0.1, False, device="cpu", root=tiny_root)
