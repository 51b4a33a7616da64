"""BENCHMARK.json against its contract, and every file it names found by
name; a file added for a new mix or metric is found with no edit elsewhere."""
import json
import re
import shutil

import pytest

from zfbench.lib import registry

BENCH = registry.benchmark()
ALL = registry.with_held(BENCH)        # with the cells held out of BENCHMARK.json
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["zfbench"]
    assert BENCH["command"] == ["python3", "zfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in ALL["workloads"]:
        e2e = {m["name"] for m in registry.cell_metrics(ALL, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = registry.cell_metrics(ALL, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_configs_found(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    assert entry["file"].startswith("zfbench/configs/")
    data = registry.config(BENCH, cfg)
    assert data["reduced"] == entry["reduced"]
    assert all(k in data for k in entry["reduced"])
    assert data["source"] == entry["source"]


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cells_find_their_traffic_and_metrics(cell):
    w = registry.cell(ALL, cell)
    t = registry.traffic(w["traffic"])
    if t["loop"] == "open":             # requests of the queries' columns, on a schedule
        cfg = registry.config(ALL, w["config"])
        columns = {c for cols in cfg["tables"].values() for c in cols}
        assert t["queries"] and all(set(c) <= columns for c in t["queries"].values())
        assert t["rate_per_s"] > 0
    else:
        assert t["calls"] and t["loop"] == "closed" and t["clients"] == 1
    for q in {c["query"] for c in t.get("calls", ()) if c["op"] == "query"}:
        assert registry.reference_query(q).COLUMNS
    for per_layer in (False, True):
        for m in registry.cell_metrics(ALL, cell, per_layer):
            assert callable(registry.metric_reader(m["name"]))


def test_added_files_are_found_without_edits(tmp_path):
    base = tmp_path / "zfbench"
    shutil.copytree(registry.ZFBENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    (base / "traffic" / "burst3.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "calls": [{"op": "load"}] * 3}))
    (base / "metrics" / "dummy_count.py").write_text(
        "def read(run, name):\n    return 7.0\n")
    assert registry.traffic("burst3", base)["name"] == "burst3"
    assert registry.metric_reader("dummy_count.serve", base)(None, "dummy_count.serve") == 7.0
    # a variant with no file of its own falls back to its prefix's reader
    assert registry.metric_path("h2d_GBps.serve", base).name == "h2d_GBps.py"
    with pytest.raises(FileNotFoundError):
        registry.metric_path("no_such_metric", base)
    with pytest.raises(ValueError):
        registry.traffic("../escape", base)


class _StubClient:
    """A client whose loads meet the shapes it is given, one a call."""

    cuda = False

    def __init__(self, shapes):
        import itertools

        self.shapes = itertools.chain(shapes, itertools.repeat({"a"}))
        self.n = 0

    def call(self, spec):
        import time

        self.n += 1
        t = time.perf_counter()
        return ({"op": "load", "t0": t, "t1": t, "shape": frozenset(next(self.shapes))},
                {"call": self.n})


def test_window_keeps_every_load_that_met_a_new_shape():
    from zfbench.lib import harness

    traffic = {"calls": [{"op": "load"}], "check": {"sampled_loads": 1},
               "trace": {"skip_s": 1.0, "calls": 1}}
    shapes = [{"a"}, {"a", "b"}, {"a"}, {"c"}, {"a", "b"}, {"a"}]
    _, kept, _ = harness.window(_StubClient(shapes), traffic, seconds=0.0, seed=2**31 + 1,
                                trace=False, seen={"a"})
    assert [k["call"] for k in kept] == [1]               # 0 s: one call, an old shape
    recs, kept, _ = harness.window(_StubClient(shapes), traffic, seconds=1e-3, seed=3,
                                   trace=False, seen={"a"})
    calls = [k["call"] for k in kept]
    assert calls[:2] == [2, 4] and len(calls) == 3        # both new shapes, and one sample
    assert calls[2] not in (2, 4)
