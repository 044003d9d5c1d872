"""BENCHMARK.json loads, keeps to the contract's shape, and every file it
names is found."""

import json
import os.path as osp
import re

import pytest

from perfbench.check import NAMES
from perfbench.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return Manifest()


def test_top_level_keys(manifest):
    assert set(manifest.data) == {"command", "paths", "run_seconds", "configs",
                                  "workloads", "end_to_end", "per_layer"}
    assert manifest.data["paths"] == ["perfbench"]
    assert 1 <= manifest.data["run_seconds"] <= 51
    assert osp.getsize(osp.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(manifest):
    d = manifest.data
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in d[kind]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in d["end_to_end"]} >= {"setup_s"}
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in d["workloads"]}
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_named_file_is_found(manifest):
    for c in manifest.data["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
    for w in manifest.data["workloads"]:
        conf = manifest.config(w["config"])
        assert conf["name"] == w["config"]
        assert manifest.traffic(w["traffic"])["frames_per_fit"] >= 1
        for kind in ("end_to_end", "per_layer"):
            assert manifest.metrics(kind, w["name"])
    for m in manifest.data["end_to_end"] + manifest.data["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_reduced_lists_the_changed_keys(manifest):
    for c in manifest.data["configs"]:
        conf = manifest.config(c["name"])
        assert conf["reduced"] == c["reduced"]
        assert set(conf["correct_limits"]) == set(NAMES)


def test_every_cell_reports_a_per_layer_metric_and_two_end_to_end(manifest):
    for w in manifest.data["workloads"]:
        e2e = [m["name"] for m in manifest.metrics("end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        moves = {m["moves"] for m in manifest.metrics("per_layer", w["name"])}
        assert moves <= set(e2e) and moves


def test_command_names_files_under_paths(manifest):
    cmd = manifest.data["command"]
    assert cmd[0] == "python3" and cmd[1].startswith("perfbench/")
    assert osp.exists(osp.join(ROOT, cmd[1]))
    json.dumps(manifest.data)
