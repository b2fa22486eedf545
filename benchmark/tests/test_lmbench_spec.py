"""BENCHMARK.json against the rules its format keeps (names, units, bounds,
the time a full check of 24 cells takes), and every file it names present:
configurations, traffic, limits and per-layer readers."""

from __future__ import annotations

import json
import re

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_budget_of_a_full_check():
    # 24 cells: (2 + 14 x 24) runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for cell in cells:  # setup_s and one more in every cell
        assert sum(cell in m.get("workloads", cells) for m in e2e.values()) >= 2


def test_files_of_every_config_cell_and_metric():
    configs = {c["name"]: c for c in SPEC["configs"]}
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["kind"] in ("serve", "train", "open_loop")
        limits = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_per_layer_readers_declare_what_the_spec_says():
    import run

    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        mod = run.metric_reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        # each listed cell reports the end-to-end metric the reader moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", m["workloads"]))
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer
