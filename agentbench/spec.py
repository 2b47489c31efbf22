"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Under the benchmark's folder:

  * ``configs/<file>``: the configuration, as ``configs[].file`` names it;
  * ``traffic/<traffic>.json``: the mix's parameters;
  * ``cells/<cell>.json``, where it exists: what belongs to the one cell
    (``traffic``: its rate or its context lengths, laid over the mix's
    parameters key by key; ``limits`` of its check; ``check``: how many
    sessions the check samples; ``sizing``: the arithmetic its lengths
    rest on);
  * ``metrics/<metric>.py``: one reader per metric, with ``read(run)``.

Adding a configuration, a mix, a cell or a metric is adding files and
entries; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
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
        self.config = load_json(self.root / conf["file"])
        folder = self.root / self.bench["paths"][0]
        self.folder = folder
        cell_file = folder / "cells" / f"{name}.json"
        cell = load_json(cell_file) if cell_file.exists() else {}
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
        path = self.folder / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"agentbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
