"""A cell's whole run at a CPU size: the result line, the metrics each
run reports, the check beside its limit, and a run that finds no card."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import REPO

SEED = 2 ** 31 + 17     # more than 32 signed bits hold


@pytest.mark.parametrize("cell", ["tiny_gqa.tiny", "tiny_mla.tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys_and_metrics(tiny_root, cell, trace):
    res = harness.run(cell, SEED, 1.0, bool(trace), device="cpu",
                      root=tiny_root)
    line = json.loads(json.dumps(res))
    want = list(harness.RESULT_KEYS) + (["breakdown"] if trace else []) \
        + ["checks"]
    assert list(line) == want         # the check comes last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    m = harness.load_manifest(tiny_root)
    names = {x["name"] for x in harness.cell_metrics(m, cell, bool(trace))}
    if trace:
        # the CPU trace has no device activity: the device's readers find
        # nothing and their metrics are left out, never 0
        assert set(line["metrics"]) == {"tune_s", "prefill_mfu"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        assert set(line["metrics"]) == names == {
            "prefill_tok_s", "prefill_ms_p95", "setup_s"}
    for v in line["metrics"].values():
        assert v["value"] > 0 and v["unit"]
    lims = json.loads((tiny_root / "perfbench" / "configs"
                       / f"{cell.split('.')[0]}.json").read_text())["limits"]
    assert set(line["checks"]) == set(lims)
    for c in line["checks"].values():
        assert 0 < c["value"] <= c["limit"]
    assert harness.check_lines(line)[0].startswith("check logits_err_")


def test_same_seed_same_inputs_and_outputs(tiny_root):
    a = harness.run("tiny_gqa.tiny", SEED, 0.2, False, device="cpu",
                    root=tiny_root)
    b = harness.run("tiny_gqa.tiny", SEED, 0.2, False, device="cpu",
                    root=tiny_root)
    assert a["checks"] == b["checks"]


def test_command_prints_the_result_as_its_last_line(tiny_root, monkeypatch,
                                                   capsys):
    """``run.py``'s own path past its look for a card: the result line is
    the last of standard output, the checks the last of standard
    error."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "perfbench_run_cli", REPO / "perfbench" / "run.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(cli, "ROOT", tiny_root)
    monkeypatch.setattr(sys, "path", list(sys.path))    # main prepends
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "")         # main sets them; undone after
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run = harness.run
    monkeypatch.setattr(harness, "run", lambda *a, **k: run(
        *a, **dict(k, device="cpu")))
    # the test process may hold JAX for other test files; a fresh process
    # is checked by test_rehearsal_loads_no_jax
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    assert cli.main(["--workload", "tiny_gqa.tiny", "--seed", str(SEED),
                     "--seconds", "0.5", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == list(harness.RESULT_KEYS) + ["checks"]
    assert err.strip().splitlines()[-1].startswith("check logits_err_")


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(REPO / "perfbench" / "run.py"), "--workload",
         "starcoder2_7b.prefill512.ppo", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA device" in p.stderr


def test_rehearsal_loads_no_jax(tiny_root):
    """A CPU rehearsal in a fresh process loads neither JAX, Flax nor the
    JAX package (top-level names compared whole), and the reference
    alone loads nothing of the program."""
    code = (
        "import sys; from perfbench import harness\n"
        f"harness.run('tiny_mla.tiny', {SEED}, 0.2, False, device='cpu', "
        f"root=__import__('pathlib').Path({str(tiny_root)!r}))\n"
        "print(harness.forbidden_modules())\n"
        "assert any(m.startswith('repro_torch') for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{REPO / 'src'}")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
    code = ("import sys, perfbench.reference\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))\n")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "repro": 1,
            "repro.core": 1, "jaxlib.xla": 1, "jaxtyping": 1, "flax": 1,
            "perfbench": 1}
    assert harness.forbidden_modules(mods) == [
        "flax", "jaxlib.xla", "repro", "repro.core"]
