"""Find a cell's pieces by name: its configuration, traffic mix, generator,
driver, per-layer metric readers and correctness limits.

Everything that belongs to one configuration, mix or metric is a file of
its own, found from the names in ``BENCHMARK.json``:

- ``benchmark_torch/configs/<config>.json`` (the ``file`` of the config);
- ``benchmark_torch/traffic/<traffic>.json``, whose ``kind`` names the
  generator module ``benchmark_torch/traffic/<kind>.py``, whose ``DRIVER``
  names the window's driver ``benchmark_torch/harness/<driver>.py``;
- ``benchmark_torch/metrics/<metric>.py`` with ``read(run)``;
- ``benchmark_torch/limits/<cell>.json``: the limits of the comparison.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "benchmark_torch"

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config named {cell['config']!r}")

    def mix(self, cell: Dict) -> Dict:
        return load_json(self.dir / "traffic" / f"{cell['traffic']}.json")

    def generator(self, kind: str) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{kind}.py",
                           f"bench_traffic_{kind}")

    def limits(self, cell: Dict) -> Dict:
        return load_json(self.dir / "limits" / f"{cell['name']}.json")

    def reports(self, metric: Dict, cell: Dict) -> bool:
        """Whether ``cell`` reports ``metric``: the cells the metric lists,
        or, without a list, every cell (a per-layer metric: every cell that
        reports the end-to-end metric it moves)."""
        if "workloads" in metric:
            return cell["name"] in metric["workloads"]
        if "moves" in metric:
            return any(e["name"] == metric["moves"] and self.reports(e, cell)
                       for e in self.bench["end_to_end"])
        return True

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [e for e in self.bench["end_to_end"] if self.reports(e, cell)]

    def per_layer(self, cell: Dict) -> List[Tuple[Dict, ModuleType]]:
        out = []
        for m in self.bench["per_layer"]:
            if self.reports(m, cell):
                out.append((m, load_module(
                    self.dir / "metrics" / f"{m['name']}.py",
                    "bench_metric_" + m["name"].replace(".", "_")
                    .replace("-", "_"))))
        return out

    def config_entry(self, name: str) -> Optional[Dict]:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return c
        return None
