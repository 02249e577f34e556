"""BENCHMARK.json and the files it names: the contract's shape, names and
units, and every piece of every cell found by name."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in bench[group]]
        assert len(ns) == len(set(ns)), group
    metrics = [e["name"] for e in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200


def test_every_piece_found_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        for path in (os.path.join(HERE, "traffic", w["traffic"] + ".json"),
                     os.path.join(HERE, "limits", w["name"] + ".json")):
            with open(path) as f:
                json.load(f)
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            entry = json.load(f)["entry"]
        assert os.path.isfile(os.path.join(HERE, "entries", entry + ".py"))
    assert used == set(configs)
    with open(os.path.join(HERE, "kernels.json")) as f:
        for k, v in json.load(f).items():
            assert os.path.isfile(os.path.join(HERE, "bounds",
                                               v["bound"] + ".py")), k
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_metric_workloads_and_moves(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        # every cell a per-layer metric lists reports the metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        reported = [m["name"] for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m["workloads"] for m in bench["per_layer"]), cell


def test_roofline_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
            assert m["name"].split(".")[0].endswith("_roofline")


def test_reduced_keys_are_in_the_config(bench):
    """Every key a configuration lists as changed from its source is a key
    of its file, with the change said under `changed`."""
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf and key in conf["changed"]


def test_checked_steps_cross_a_switch():
    """The banded cell's checked steps hold a view and then switch, so the
    comparison covers a stale held step and a rebind; the unbanded cell's
    take a new view each step."""
    from portbench import generator, harness
    for workload, want in (("garden5m.train_held10", [True, False, True]),
                           ("synth300k.train_views", [True, True, True])):
        cell = harness.load_cell(workload)
        for seed in (1, 2 ** 31 + 5):
            order = generator.Mix(cell.traffic, cell.config,
                                  seed).check_order()
            fresh = [k == 0 or order[k] != order[k - 1]
                     for k in range(len(order))]
            assert fresh == want, (workload, order)
            assert not set(order) & set(cell.traffic["held_out"])
