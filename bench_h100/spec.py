"""What a cell is made of, found by name: BENCHMARK.json at the checkout's
root names each cell's configuration and traffic mix; the configuration
is `configs/<config>.json`, the mix `mixes/<traffic>.json`, the check's
limits `cells/<workload>.json`, a per-layer metric's reader
`metrics/<metric>.py` (a metric `base.variant` is read by
`metrics/<base>.py`), a scene or environment generator
`scenes/<generator>.py`, a mix's launch loop `kinds/<kind>.py`, a
configuration's plain reference `reference/<reference>.py` (`render`
unless the configuration names another).  A later cell, mix,
configuration or metric is added by adding files and entries, never by
editing one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{check_name(name)}.json").read_text())


def workload(bench: dict, name: str) -> dict:
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return found[0]


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") that cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The module that reads per-layer metric `metric`: metrics/<metric>.py,
    else metrics/<its name before the first dot>.py."""
    check_name(metric)
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return _module(path, f"bench_h100_metric_{stem}")
    raise SystemExit(f"no reader for per-layer metric {metric!r} in bench_h100/metrics/")


def generator(name: str):
    """The scene or environment generator scenes/<name>.py."""
    return _module(HERE / "scenes" / f"{check_name(name)}.py", f"bench_h100_scene_{name}")


def reference(config: dict):
    """The plain reference that a configuration names (reference/render.py
    unless it names another)."""
    import importlib

    return importlib.import_module(f"bench_h100.reference.{check_name(config.get('reference', 'render'))}")


def kind(name: str):
    """The launch loop kinds/<name>.py that a mix names as its `kind`."""
    return _module(HERE / "kinds" / f"{check_name(name)}.py", f"bench_h100_kind_{name}")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
