"""The general run: one cell of ``BENCHMARK.json``, once.

The manifest names the cell's configuration and traffic; the traffic
file's ``kind`` names the module under ``kinds/`` that sets the cell up,
runs its window and checks its outputs, and returns a :class:`Record`.
Each metric the cell reports is read from that record by
``metrics/<name>.py``: the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``.  A reader that finds nothing to read
returns ``None`` and its metric is left out of the line.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from perfbench.spec import ModelSpec, load_config, spec_from_config

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


@dataclass
class Trace:
    """The traced prefills: the timeline and its window (microseconds)."""
    events: list
    t0: float
    t1: float
    prefills: int


@dataclass
class Record:
    """What one run measured, for the metric readers."""
    spec: ModelSpec
    batch: int
    seq: int
    setup_s: float
    window_s: float
    latencies_s: List[float]
    tune_s: float = 0.0
    trace: Optional[Trace] = None
    after_trace: Tuple[int, float] = (0, 0.0)   # untraced prefills, seconds
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    correct: bool = False
    failed: int = 0
    device: dict = field(default_factory=dict)

    @property
    def prefills(self) -> int:
        return len(self.latencies_s)


@dataclass
class Cell:
    """A cell as the manifest and its files give it."""
    name: str
    chips: int
    config: dict
    config_name: str
    traffic: dict
    spec: ModelSpec


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(sorted(cells))})")
    w = cells[name]
    c = {x["name"]: x for x in manifest["configs"]}[w["config"]]
    config = load_config(Path(root) / c["file"])
    with open(Path(root) / "perfbench" / "workloads"
              / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, c["name"], traffic,
                spec_from_config(config, c["name"]))


def load_module(path: Path):
    """A module from its file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench._file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (those that list it, or, without a
    ``workloads`` key, those whose ``moves`` it reports)."""
    e2e = [m for m in manifest["end_to_end"] if _applies(m, cell)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metrics(rec: Record, metrics: List[dict], root: Path = ROOT
                 ) -> dict:
    out = {}
    for m in metrics:
        reader = load_module(Path(root) / "perfbench" / "metrics"
                             / f"{m['name']}.py")
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        root: Path = ROOT, manifest: Optional[dict] = None) -> dict:
    """Run one cell once and return its result line as a dict."""
    import time
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or load_manifest(root)
    cell = load_cell(manifest, workload, root)
    kind = load_module(Path(root) / "perfbench" / "kinds"
                       / f"{cell.traffic['kind']}.py")
    rec = kind.run(cell, seed=seed, seconds=seconds, trace=trace,
                   device=device, t_start=t_start)
    result = {"correct": bool(rec.correct), "attempted": rec.prefills,
              "failed": rec.failed,
              "metrics": read_metrics(rec, cell_metrics(
                  manifest, workload, trace), root),
              "device": dict(rec.device)}
    if trace and rec.trace is not None:
        from perfbench import timeline as tl
        t = rec.trace
        result["breakdown"] = {
            "device_ops": tl.top(tl.device_us_by_name(t.events, t.t0, t.t1)),
            "idle_gaps": tl.top(tl.idle_by_host_op(t.events, t.t0, t.t1))}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in rec.checks.items()}
    return result


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is JAX's, Flax's or the
    JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def check_lines(result: dict) -> List[str]:
    """The numbers compared, each beside its limit, one a line."""
    return [f"check {k}: {c['value']!r} limit {c['limit']!r} "
            f"({'pass' if c['value'] <= c['limit'] else 'FAIL'})"
            for k, c in result["checks"].items()]
