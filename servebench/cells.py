"""Finds what a cell is made of, by the names in ``BENCHMARK.json``: its
configuration ``servebench/configs/<config>.json``, its traffic mix
``servebench/traffic/<traffic>.json``, and each metric's reader
``servebench/metrics/<name>.py`` (or, where there is none, the reader named
by the part of the metric's name before its first dot: ``mfu.chat`` is read
by ``metrics/mfu.py``). A configuration's plain reference is the module its
file names under ``reference``. Nothing here knows a cell by name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({[w['name'] for w in bench['workloads']]})")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def config(root: Path, name: str) -> dict:
    return _json(root / "servebench" / "configs" / f"{name}.json")


def traffic(root: Path, name: str) -> dict:
    return _json(root / "servebench" / "traffic" / f"{name}.json")


def _load(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """The module whose ``read(run)`` gives ``metric``."""
    base = root / "servebench" / "metrics"
    for stem in (metric, metric.split(".")[0]):
        path = base / f"{stem}.py"
        if path.is_file():
            return _load(path, f"servebench_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {metric!r} under {base}")


def reference(root: Path, cfg_file: dict):
    name = cfg_file["reference"]["module"]
    return _load(root / "servebench" / "reference" / f"{name}.py",
                 f"servebench_reference_{name}")


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those that list the cell, and those with no list whose moved metric
    the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
