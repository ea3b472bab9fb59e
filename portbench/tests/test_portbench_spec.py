"""BENCHMARK.json keeps to the contract, and the harness finds every cell,
configuration, model family, traffic mix, limit and per-layer metric by
its name."""

import json
import os
import re

import pytest

from portbench import spec
from portbench.tests.tiny import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "per_layer":
            assert e["workloads"] and set(e["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = spec.load_cell(ROOT, workload)
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m.moves in e2e for m in cell.per_layer)
    assert cell.chips in (1, 4)
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       cell.traffic["kind"] + ".py"))
    assert cell.limits["max_logit_gap"]["limit"] > 0


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    body = json.load(open(os.path.join(ROOT, config["file"])))
    assert body["source"] == config["source"] and body["reduced"] == config["reduced"]
    assert os.path.isfile(os.path.join(ROOT, "portbench", "families", body["model_type"] + ".py"))
    family = spec.family(body["model_type"])
    assert all(callable(getattr(family, f)) for f in ("dims", "judge", "port_model"))
    assert isinstance(family.CONTROL, str)
    assert family.dims(body) is not None
    if body["model_type"] == "whisper":
        assert body["d_model"] == 1280 and body["encoder_layers"] == 32 and body["reduced"] == []


def test_unknown_model_type_names_the_path_it_looked_for():
    with pytest.raises(FileNotFoundError, match=r"families[/\\]no_such_family\.py"):
        spec.family("no_such_family")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.reader(metric))
