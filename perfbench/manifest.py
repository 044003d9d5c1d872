"""The benchmark's manifest, `BENCHMARK.json` at the repository root, and
the files it names by name: a configuration `configs/<config>.json`, a
traffic mix `traffic/<traffic>.json`, and a per-layer metric's reader
`metrics/<name>.py` (or, for a name with a suffix such as
`idle_share.frames`, `metrics/<name before the first dot>.py`).  A cell,
a configuration or a metric is added by adding files and entries."""

from __future__ import annotations

import importlib.util
import json
import os.path as osp

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = _json(osp.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(osp.join(HERE, "configs", name + ".json"))

    def traffic(self, name: str) -> dict:
        return _json(osp.join(HERE, "traffic", name + ".json"))

    def metrics(self, kind: str, workload: str) -> list:
        """The `end_to_end` or `per_layer` metrics a workload reports."""
        return [m for m in self.data[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The `read(run)` function of a per-layer metric."""
        for stem in (metric, metric.split(".")[0]):
            path = osp.join(HERE, "metrics", stem + ".py")
            if osp.exists(path):
                spec = importlib.util.spec_from_file_location(
                    "perfbench.metrics." + stem.replace(".", "_"), path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for the metric {metric!r}")
