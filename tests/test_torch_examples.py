"""The four examples ported last, each run with ``--device cpu`` in a
subprocess and held to its own invariants: ``torch_measured_autotune.py``
(a second run on the same DB times 0 pairs, in-process then through a
pool), ``torch_warmstart_autotune.py`` (fit, then warm in a fresh
process: a store lookup and 0 agent inferences), ``torch_fleet_autotune.py``
(against a ``serve-worker`` and a ``serve-artifacts`` daemon on
localhost: run 1 times every pair and a watcher receives the program by
push, run 2 times 0 pairs and is a store hit) and
``torch_fault_tolerant_serving.py`` at Jamba's reduced config, its plan
injected (the plain versions on the CPU, within 1e-5 of eager), whose
plan under ``legality="tpu_v5e"`` and re-plan lines equal the reference
example's.  Without ``--device cpu`` and without CUDA each raises."""
import os
import re
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="2")


def _run(script, *args, timeout=120):
    r = subprocess.run([sys.executable, os.path.join(EX, script), *args],
                       capture_output=True, text=True, env=ENV, cwd=ROOT,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def _timed(out):
    return int(re.search(r"measurements: (\d+) timed", out).group(1))


def test_measured_second_run_times_nothing(tmp_path):
    db = str(tmp_path / "m.jsonl")
    common = ["--device", "cpu", "--db", db, "--out",
              str(tmp_path / "t.json")]
    first = _run("torch_measured_autotune.py", *common)
    assert _timed(first) > 0 and "plain(dim<=128,b<=2)" in first
    second = _run("torch_measured_autotune.py", *common, "--transport",
                  "pool", "--workers", "2")
    assert _timed(second) == 0 and "hit rate 1.00" in second
    for out in (first, second):
        assert out.rstrip().endswith("OK")
    assert re.findall(r"tiles=\(.*\)", first) == \
        re.findall(r"tiles=\(.*\)", second)


def test_warmstart_fit_then_warm(tmp_path):
    paths = ["--device", "cpu", "--artifact", str(tmp_path / "art"),
             "--store", str(tmp_path / "p.jsonl"), "--expect",
             str(tmp_path / "cold.json")]
    fit = _run("torch_warmstart_autotune.py", "--phase", "fit", *paths)
    assert "saved facade artifact" in fit and fit.rstrip().endswith("OK")
    warm = _run("torch_warmstart_autotune.py", "--phase", "warm", *paths)
    assert "tune 1: agent inferences 0, store hits 1" in warm
    assert "tune 2: agent inferences 0" in warm
    assert "round-trip invariant: OK" in warm
    assert warm.rstrip().endswith("OK")


def _daemon(args, log):
    f = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.fleet",
                             *args, "--host", "127.0.0.1", "--port", "0"],
                            stdout=f, stderr=subprocess.STDOUT, env=ENV,
                            cwd=ROOT)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and proc.poll() is None:
        with open(log) as g:
            m = re.search(r"ready on (\S+)", g.read())
        if m:
            return proc, m.group(1)
        time.sleep(0.1)
    proc.kill()
    with open(log) as g:
        raise AssertionError(f"{args[0]} never got ready: {g.read()[-2000:]}")


def test_fleet_two_runs_against_local_daemons(tmp_path):
    procs = []
    try:
        w, worker = _daemon(["serve-worker", "--transport", "inproc",
                             "--device", "cpu"], tmp_path / "w.log")
        procs.append(w)
        a, arts = _daemon(["serve-artifacts", "--measure-db",
                           str(tmp_path / "m.jsonl"), "--program-store",
                           str(tmp_path / "p.jsonl")], tmp_path / "a.log")
        procs.append(a)
        args = ["--hosts", worker, "--artifacts", arts, "--device", "cpu",
                "--out", str(tmp_path / "t.json")]
        first = _run("torch_fleet_autotune.py", *args)
        assert _timed(first) > 0
        assert "push-invalidation: serving client observed" in first
        second = _run("torch_fleet_autotune.py", *args)
        assert _timed(second) == 0
        assert "store warm: 1 tune(s) answered by shared program-store " \
               "lookup (0 agent inferences)" in second
        for out in (first, second):
            assert "1/1 live" in out and out.rstrip().endswith("OK")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def _reference_example(monkeypatch, capsys):
    """The reference example in this process, its decode steps stubbed
    (what is compared comes before and after them), its plan kept."""
    import importlib.util
    from repro.api import NeuroVectorizer as JNV
    progs = []
    tune = JNV.tune_sites
    monkeypatch.setattr(JNV, "tune_sites", lambda self, sites: progs.append(
        tune(self, sites)) or progs[-1])
    spec = importlib.util.spec_from_file_location(
        "reference_fault_tolerant_serving",
        os.path.join(EX, "fault_tolerant_serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "make_serve_step", lambda model: (
        lambda params, tok, pos, cache: (tok, None, cache)))
    mod.main()
    return progs[0], capsys.readouterr().out


def test_fault_tolerant_serving_reduced(tmp_path, monkeypatch, capsys):
    from repro_torch.api import TileProgram
    tiles = str(tmp_path / "plan.json")
    # the port's run in its subprocess while the reference runs here
    port = subprocess.Popen(
        [sys.executable, os.path.join(EX, "torch_fault_tolerant_serving.py"),
         "--device", "cpu", "--legality", "tpu_v5e", "--save-tiles", tiles,
         "--inject"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=ROOT)
    try:
        ref_prog, ref_out = _reference_example(monkeypatch, capsys)
        out, err = port.communicate(timeout=120)
    finally:
        port.kill()
    assert port.returncode == 0, out[-2000:] + err[-3000:]
    assert "decoded 12 tokens/request" in out
    assert re.search(r"\d+ straggler events", out)
    # injected on the CPU: the plain versions, the eager prefill's logits
    rel = float(re.search(r"over max \|eager logit\| (\S+)", out).group(1))
    assert rel < 1e-5
    assert out.rstrip().endswith("OK")
    got = TileProgram.load(tiles).tiles
    assert got.keys() == ref_prog.tiles.keys() and got
    assert all(tuple(got[k]) == tuple(ref_prog.tiles[k]) for k in got)
    replans = [ln for ln in out.splitlines() if "healthy chips" in ln]
    assert len(replans) == 4
    assert replans == [ln for ln in ref_out.splitlines()
                       if "healthy chips" in ln]


@pytest.mark.parametrize("script,args", [
    ("torch_measured_autotune.py", []),
    ("torch_warmstart_autotune.py", ["--phase", "fit"]),
    ("torch_fleet_autotune.py", ["--hosts", "127.0.0.1:1",
                                 "--artifacts", "127.0.0.1:1"]),
    ("torch_fault_tolerant_serving.py", [])])
def test_without_cuda_the_examples_raise(script, args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(EX, script), *args],
                       capture_output=True, text=True, env=ENV, cwd=ROOT,
                       timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr or "no CUDA device" in r.stdout
