"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``portbench/configs/<config>.json`` (the entry's
``file``), whose ``reference`` names its plain reference
``portbench/reference/<module>.py``; a traffic mix
``portbench/traffic/<traffic>.json``, with, where the one generator
cannot make it, its own ``portbench/traffic/<traffic>.py``; a per-layer
metric's reader ``portbench/metrics/<metric>.py`` and a cell's
correctness limits ``portbench/limits/<cell>.json``.  Adding any of them
is adding a file; nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Dict, List, Optional

PORTBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}


def load(root: pathlib.Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config_file(bench: Dict, name: str, root: pathlib.Path = ROOT) -> Dict:
    return read_json(root / config_entry(bench, name)["file"])


def traffic_file(name: str, root: pathlib.Path = ROOT) -> Dict:
    return read_json(root / "portbench" / "traffic" / f"{name}.json")


def limits_file(cell: str, root: pathlib.Path = ROOT) -> Dict:
    return read_json(root / "portbench" / "limits" / f"{cell}.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    """The end-to-end metrics a cell reports (``--trace 0``)."""
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics a cell reports (``--trace 1``): those that
    list it, and those without a list whose end-to-end metric it
    reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def _load(path: pathlib.Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``."""
    return _load(root / "portbench" / "metrics" / f"{metric}.py",
                 "portbench_metric_").read


def generator(mix: str, root: pathlib.Path = ROOT):
    """The ``requests(mix, vocab, seed, seconds)`` function of
    ``portbench/traffic/<mix>.py`` where the mix has one, else None (the
    one generator, ``harness.traffic.serve_requests``, makes it)."""
    path = root / "portbench" / "traffic" / f"{mix}.py"
    if not path.is_file():
        return None
    return _load(path, "portbench_traffic_").requests


def reference_module(model: Dict):
    """The plain reference a configuration names (its ``reference``)."""
    from reference import module_of
    return module_of(model)


def problems(bench: Dict, root: pathlib.Path = ROOT) -> List[str]:
    """What in ``bench`` breaks the benchmark's contract, or the files
    it names are missing (an empty list when nothing does)."""
    out: List[str] = []

    def name_ok(kind: str, n: str) -> None:
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{kind} name {n!r}")

    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
        if not (root / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
            continue
        ref = read_json(root / c["file"]).get("reference", "")
        if (str(pathlib.PurePosixPath(ref).parent) != "portbench/reference"
                or not ref.endswith(".py") or not (root / ref).is_file()):
            out.append(f"config {c['name']}: reference {ref!r} is not a "
                       f"file of portbench/reference/")
    cells = set()
    for w in bench["workloads"]:
        name_ok("workload", w["name"])
        name_ok("traffic", w["traffic"])
        cells.add(w["name"])
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        if len(w["why"]) > 200 or "\n" in w["why"] or "\t" in w["why"]:
            out.append(f"{w['name']}: why")
        for path in (root / "portbench" / "traffic" / f"{w['traffic']}.json",
                     root / "portbench" / "limits" / f"{w['name']}.json"):
            if not path.is_file():
                out.append(f"{w['name']}: {path.name} missing")
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        name_ok("metric", m["name"])
        if m["name"] in names:
            out.append(f"metric {m['name']} twice")
        names.add(m["name"])
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: unknown cell {c}")
    for m in bench["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            out.append(f"{m['name']}: end-to-end source {m['source']}")
    for m in bench["per_layer"]:
        for c in m.get("workloads", sorted(cells)):
            if m["moves"] not in {e["name"] for e in end_to_end(bench, c)}:
                out.append(f"{m['name']} moves {m['moves']}, which {c} "
                           f"does not report")
        if not (root / "portbench" / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: reader missing")
    for c in cells:
        e2e = [m["name"] for m in end_to_end(bench, c)]
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"{c}: end-to-end metrics {e2e}")
        if not per_layer(bench, c):
            out.append(f"{c}: no per-layer metric")
    used = {w["config"] for w in bench["workloads"]}
    for c in configs - used:
        out.append(f"config {c} used by no cell")
    return out


def top_level(names) -> set:
    """Top-level package names of module names, compared whole."""
    return {n.split(".")[0] for n in names}


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_loaded(modules) -> Optional[List[str]]:
    bad = sorted(top_level(modules) & FORBIDDEN)
    return bad or None
