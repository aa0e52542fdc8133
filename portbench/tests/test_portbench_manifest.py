"""BENCHMARK.json and the files it names: the contract's shape, every
cell, configuration and metric found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert all("/" not in w or w.startswith("portbench")
               for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries_keys_and_names(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                      "per_layer")
                         else set()), (e["name"], extra)
        assert KEYS[section] <= set(e), e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        e2e = {m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", [])]
        assert layer, cell


def test_per_layer_moves_a_metric_every_listed_cell_reports():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            e2e = {e["name"] for e in BENCH["end_to_end"]
                   if cell in e.get("workloads", [cell])}
            assert m["moves"] in e2e, (m["name"], cell)


def test_roofline_and_layer_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_cells_use_one_chip_and_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_file_found_by_name(cell):
    spec = json.loads((PKG / "cells" / f"{cell}.json").read_text())
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert spec["config"] == entry["config"]
    assert spec["why"] == entry["why"]
    assert (PKG / "drivers" / f"{spec['driver']}.py").is_file()
    assert (PKG / "configs" / f"{spec['config']}.json").is_file()
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_found_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    spec = json.loads((ROOT / entry["file"]).read_text())
    assert spec["source"] == entry["source"]
    assert spec["reduced"] == entry["reduced"] == []
    assert spec["control_precision"] in ("int4", "bf16")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert (PKG / "metrics" / f"{metric}.py").is_file()


def test_a_full_check_fits_the_budget():
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200
