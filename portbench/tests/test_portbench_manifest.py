"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, and a file under portbench/ for every configuration, traffic mix,
metric and cell it names."""

import json
import re

import pytest

from portbench.tests.small import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entries_have_only_their_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_cell_reports_what_it_must():
    b = bench()
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in b["per_layer"] if w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics", "limits"])
def test_files_found_by_name(kind):
    b = bench()
    if kind == "configs":
        paths = [ROOT / c["file"] for c in b["configs"]]
        for c in b["configs"]:
            assert json.loads((ROOT / c["file"]).read_text())["reduced"] == []
    elif kind == "traffic":
        paths = [ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                 for w in b["workloads"]]
    elif kind == "metrics":
        paths = [ROOT / "portbench" / "metrics" / f"{m['name']}.py"
                 for m in b["end_to_end"] + b["per_layer"]]
    else:
        paths = [ROOT / "portbench" / "limits" / f"{w['name']}.json"
                 for w in b["workloads"]]
        paths += [ROOT / "portbench" / "checks"
                  / f"{json.loads(p.read_text())['check']}.py"
                  for p in paths]
    for p in paths:
        assert p.is_file(), p


def test_metric_readers_declare_their_unit():
    from portbench.run import reader
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert reader(m["name"]).UNIT == m["unit"], m["name"]
