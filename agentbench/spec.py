"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Under the benchmark's folder:

  * ``configs/<file>``: the configuration, as ``configs[].file`` names it;
    its ``kind`` (``dense`` where it names none) names the next two;
  * ``kinds/<kind>.py``: what the harness reads of the model's shape (the
    port's configuration, the weight draw, the work counts, how long a
    session may grow; ``agentbench/kinds/__init__.py``);
  * ``reference/<module>.py``: the kind's plain reference, as its
    ``REFERENCE`` names it;
  * ``traffic/<traffic>.json``: the mix's parameters;
  * ``cells/<cell>.json``, where it exists: what belongs to the one cell
    (``config``: configuration keys laid over the configuration file key
    by key, such as its own ``engine.num_blocks``; ``traffic``: its rate
    or its context lengths, laid over the mix's parameters the same way;
    ``limits`` of its check; ``check``: how many sessions the check
    samples; ``sizing``: the arithmetic its lengths rest on);
  * ``metrics/<metric>.py``: one reader per metric, with ``read(run)``.

Adding a configuration, a kind, a mix, a cell or a metric is adding files
and entries; no file here names one.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def merged(base: Dict, over: Dict) -> Dict:
    """``over`` laid on ``base``: nested dicts merge, everything else is
    replaced."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(by_name)}")
        self.entry = by_name[name]
        self.name = name
        conf = {c["name"]: c for c in self.bench["configs"]}[
            self.entry["config"]]
        folder = self.root / self.bench["paths"][0]
        self.folder = folder
        cell_file = folder / "cells" / f"{name}.json"
        cell = load_json(cell_file) if cell_file.exists() else {}
        self.config = merged(load_json(self.root / conf["file"]),
                             cell.get("config", {}))
        self.traffic = merged(
            load_json(folder / "traffic" / f"{self.entry['traffic']}.json"),
            cell.get("traffic", {}))
        self.limits: Dict[str, float] = cell.get("limits", {})
        self.check = cell.get("check", {})
        self.sizing = cell.get("sizing", {})

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics this cell reports: the end-to-end ones without a
        trace, the per-layer ones with it, each where its ``workloads``
        lists the cell or where it has no such key."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Callable:
        return self._load("metrics", metric).read

    @functools.cached_property
    def kind(self) -> ModuleType:
        """``kinds/<kind>.py`` of the configuration."""
        return self._load("kinds", self.config.get("kind", "dense"))

    @functools.cached_property
    def reference(self) -> ModuleType:
        """``reference/<module>.py``, as the kind's ``REFERENCE`` names
        it."""
        return self._load("reference", self.kind.REFERENCE)

    def _load(self, folder: str, name: str) -> ModuleType:
        """``<folder>/<name>.py`` under the benchmark's folder, by path."""
        spec = importlib.util.spec_from_file_location(
            f"agentbench_{folder}_{name.replace('.', '_')}",
            self.folder / folder / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
