"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def test_top_level_and_sizes():
    assert set(SPEC) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    cells = len(SPEC["workloads"])
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).exists()


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)


def test_configs_files_and_reduced():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and sorted(c["reduced"]) == sorted(data["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not key.endswith(("_dim", "_rank", "_size", "channels", "heads"))


def test_workloads_and_metrics():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")

    def reports(cell, metric):
        return cell in metric.get("workloads", [cell])

    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        own = [m for m in SPEC["end_to_end"] if reports(w["name"], m)]
        assert any(m["name"] == "setup_s" for m in own) and len(own) >= 2
        assert any(reports(w["name"], m) for m in SPEC["per_layer"])
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert reports(cell, e2e[m["moves"]]), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # Beside a kernel's roofline, the whole step's share of the peak moves
    # the same end-to-end metric in the same cells.
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            for cell in m["workloads"]:
                assert any("mfu" in o["name"] and o["moves"] == m["moves"] and reports(cell, o)
                           for o in SPEC["per_layer"]), (m["name"], cell)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    from benchmark import common, run

    cell, config, traffic = common.cell_files(workload)
    entry = next(w for w in SPEC["workloads"] if w["name"] == workload)
    assert cell["name"] == workload and cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"] and cell["chips"] == entry["chips"]
    assert cell["why"] == entry["why"]
    assert config["name"] == entry["config"]
    assert run.cell_class(traffic["kind"]).name == traffic["kind"]
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    for m in run.cell_metrics(SPEC, workload, True):
        assert callable(common.metric_reader(m["name"]))
