"""BENCHMARK.json and the files it names: found by name, within the
benchmark's contract."""

import json
import re

import pytest

from portbench import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    raw = (manifest.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = manifest.workload(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = manifest.config(w["config"])
    traffic = manifest.traffic(w["traffic"])
    entry = manifest.entry(traffic["entry"])
    kind = manifest.kind(entry.KIND)
    for fn in ("reference", "check_answer", "control", "work"):
        assert callable(getattr(kind, fn))
    assert callable(manifest.generator(cfg["generator"]).generate)
    limits = manifest.limits(cell)
    assert limits and all(v >= 0 for v in limits.values())
    for trace in (False, True):
        for m in manifest.metrics_for(BENCH, cell, trace):
            assert callable(manifest.reader(m["name"]).read)
    e2e = [m["name"] for m in manifest.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_for(BENCH, cell, True)


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert key in cfg and NAME.match(key)
            assert not re.search(r"(_dim|_rank|width|hidden)$", key)


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert {m["name"].split(".")[0] for m in e2e} == {
        "mteps", "query_p95_ms", "peak_mem_gib", "setup_s"}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e_names = {m["name"] for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e_names
        # every cell that reports the metric reports what it moves
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in {x["name"] for x in
                                  manifest.metrics_for(BENCH, cell, False)}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert manifest.reader_path(m["name"]).is_file()


def test_names_and_pairs():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    for w in BENCH["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
