"""Where the benchmark finds what belongs to one configuration, traffic mix,
metric or reference query: by the name that ``BENCHMARK.json`` gives it.

A later change adds a cell by adding files under ``zfbench/`` and entries in
``BENCHMARK.json``; nothing here has to be edited for it:

* a configuration is the JSON file its ``configs`` entry names;
* a traffic mix ``<mix>`` is ``zfbench/traffic/<mix>.json``, data
  that the closed-loop driver (``lib/harness.py``) or, with ``"loop":
  "open"``, the open loop (``lib/serve.py``) reads;
* a metric ``<a>.<b>`` is read by ``zfbench/metrics/<a>.<b>.py``, or, where that
  file is absent, by ``zfbench/metrics/<a>.py`` (one reader for every variant);
* a cell held out of ``BENCHMARK.json`` while the program fails it, or
  while its runs spread past the widest bound the benchmark allows, is
  ``zfbench/held/<cell>.json``: its entries, ready to go back, and why
  (the tests still drive it through a rehearsed run);
* a query ``<q>`` is ``zfbench/queries/<q>.json``, data that
  ``lib/queries.py`` builds into the port's ``QueryPlan``, and its NumPy
  reference is ``zfbench/reference/queries/<q>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ZFBENCH = Path(__file__).resolve().parents[1]
ROOT = ZFBENCH.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str, what: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def with_held(bench: dict, base: Path = ZFBENCH) -> dict:
    """``bench`` with the held-out cells' entries added."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    for path in sorted((base / "held").glob("*.json")):
        frag = json.loads(path.read_text())
        for group in ("workloads", "end_to_end", "per_layer"):
            out[group] += frag.get(group, [])
    return out


def cell(bench: dict, workload: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                   f"(has {[c['name'] for c in bench['workloads']]})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            cfg = json.loads((root / c["file"]).read_text())
            if cfg.get("name") != name:
                raise ValueError(f"{c['file']} names itself {cfg.get('name')!r}, not {name!r}")
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = ZFBENCH) -> dict:
    check_name(name, "traffic")
    path = base / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file zfbench/traffic/{name}.json")
    data = json.loads(path.read_text())
    data.setdefault("name", name)
    return data


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"zfbench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_path(name: str, base: Path = ZFBENCH) -> Path:
    """The reader of metric ``name``: its own file, else that of the longest
    dot-separated prefix that has one."""
    check_name(name, "metric")
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = base / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader zfbench/metrics/{name}.py (nor of a prefix)")


def metric_reader(name: str, base: Path = ZFBENCH):
    """``read(run, name) -> float | None`` of metric ``name``."""
    return _module(metric_path(name, base), "metric").read


def query(name: str, base: Path = ZFBENCH) -> dict:
    """The contents of query file ``name``."""
    check_name(name, "query")
    path = base / "queries" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no query file zfbench/queries/{name}.json")
    data = json.loads(path.read_text())
    if data.get("name") != name:
        raise ValueError(f"zfbench/queries/{name}.json names itself {data.get('name')!r}")
    return data


def reference_query(name: str, base: Path = ZFBENCH):
    """The NumPy reference of query ``name``: a module with ``COLUMNS``,
    ``N_SEGMENTS`` and ``lanes(cols, precision)``."""
    check_name(name, "query")
    path = base / "reference" / "queries" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference query zfbench/reference/queries/{name}.py")
    return _module(path, "query")


def cell_metrics(bench: dict, workload: str, per_layer: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones with ``per_layer``
    False, its per-layer ones with True.  A metric with ``workloads`` is
    reported in those cells; a per-layer one without it, in every cell that
    reports the end-to-end metric it moves; an end-to-end one without it, in
    every cell."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
