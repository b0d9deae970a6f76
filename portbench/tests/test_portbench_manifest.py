"""BENCHMARK.json against the contract, and the harness finding new
files by name."""
import ast
import json
import pathlib
import shutil
import sys
import types

import pytest
import torch

from smallcfg import PORTBENCH, ROOT, small_mix, small_model
from harness import manifest


def test_manifest_has_no_problems(bench):
    assert manifest.problems(bench) == []


def test_names_and_units_use_allowed_characters(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.NAME.match(m["name"]), m["name"]
        assert manifest.UNIT.match(m["unit"]), m["unit"]
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            assert manifest.NAME.match(w[key]), w[key]
    for c in bench["configs"]:
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    bad = dict(bench["end_to_end"][0], name="tok per s", unit="tokens per s")
    probs = manifest.problems(dict(bench, end_to_end=[bad]
                                   + bench["end_to_end"][1:]))
    assert any("name" in p for p in probs)
    assert any("unit" in p for p in probs)


def test_every_per_layer_metric_cell_reports_what_it_moves(bench):
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            moved = {e["name"] for e in manifest.end_to_end(bench, cell)}
            assert m["moves"] in moved, (m["name"], cell)
    # a metric listed for a cell that does not report its end-to-end
    # metric is a problem
    wrong = dict(bench["per_layer"][0], workloads=["olmo-1b.train"])
    assert manifest.problems(dict(bench, per_layer=[wrong]
                                  + bench["per_layer"][1:]))


def test_every_cell_reports_setup_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        names = [m["name"] for m in manifest.end_to_end(bench, w["name"])]
        assert "setup_s" in names and len(names) >= 2
        assert manifest.per_layer(bench, w["name"])
        assert w["chips"] == 1


def test_limits_files_name_their_readings(bench):
    for w in bench["workloads"]:
        lim = manifest.limits_file(w["name"])
        for k, v in lim.items():
            assert v["limit"] > 0, (w["name"], k)


def test_new_files_are_found_without_editing_existing_ones(tmp_path):
    """A configuration, a mix, a metric and a cell added as new files
    (and entries) in a copy run through the harness unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pb = root / "portbench"
    model = dict(small_model("olmo-1b"), name="olmo-tiny")
    (pb / "configs" / "olmo-tiny.json").write_text(json.dumps(model))
    mix = small_mix(manifest.traffic_file("batch"))
    mix["engine"]["num_slots"] = mix["sessions"] = 2
    (pb / "traffic" / "tiny-batch.json").write_text(json.dumps(mix))
    from test_portbench_traffic import OPEN
    (pb / "traffic" / "tiny-chat.json").write_text(json.dumps(
        small_mix(OPEN)))
    (pb / "metrics" / "steps.tiny.py").write_text(
        "def read(run):\n    return float(len(run.steps))\n")
    for cell in ("olmo-tiny.tiny-batch", "olmo-tiny.tiny-chat"):
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps({"max_logit_gap": {"limit": 1.0}}))
    bench = manifest.load(root)
    bench["configs"].append({"name": "olmo-tiny", "source": "test",
                             "file": "portbench/configs/olmo-tiny.json",
                             "reduced": [], "why": "test"})
    for mix_name in ("tiny-batch", "tiny-chat"):
        bench["workloads"].append({"name": f"olmo-tiny.{mix_name}",
                                   "config": "olmo-tiny",
                                   "traffic": mix_name, "chips": 1,
                                   "why": "test"})
    bench["end_to_end"] += [
        {"name": "ttft_p90_ms", "unit": "ms", "better": "lower",
         "bound": 0.1, "source": "host_clock",
         "workloads": ["olmo-tiny.tiny-chat"]},
        {"name": "itl_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.1, "source": "host_clock",
         "workloads": ["olmo-tiny.tiny-chat"]}]
    bench["per_layer"].append({"name": "queue_ms_p90.chat", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine", "moves": "ttft_p90_ms",
                               "workloads": ["olmo-tiny.tiny-chat"]})
    bench["per_layer"].append({"name": "steps.tiny", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "decode_tok_s",
                               "workloads": ["olmo-tiny.tiny-batch"]})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_tok_s":
            m["workloads"].append("olmo-tiny.tiny-batch")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.problems(bench, root) == []
    for p, data in before.items():
        assert p.read_bytes() == data, p
    import run
    out = run.execute("olmo-tiny.tiny-batch", 5, 0.5, True,
                      torch.device("cpu"), root=root)
    assert out["correct"], out
    assert out["metrics"]["steps.tiny"]["value"] >= 1
    out = run.execute("olmo-tiny.tiny-batch", 5, 0.5, False,
                      torch.device("cpu"), root=root)
    assert set(out["metrics"]) == {"decode_tok_s", "setup_s"}
    assert list(out)[-1] == "checks"
    # the open loop, through the readers a chat cell would use
    out = run.execute("olmo-tiny.tiny-chat", 6, 3.0, False,
                      torch.device("cpu"), root=root)
    assert out["correct"], out
    assert set(out["metrics"]) == {"ttft_p90_ms", "itl_p95_ms", "setup_s"}
    out = run.execute("olmo-tiny.tiny-chat", 6, 3.0, True,
                      torch.device("cpu"), root=root)
    assert "queue_ms_p90.chat" in out["metrics"]


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, root / "portbench"


def _tiny_batch_cell(root, pb, name, mix_extra=None, model_extra=None):
    """A small closed-loop cell ``olmo-tiny.<name>`` added as files."""
    model = dict(small_model("olmo-1b"), name="olmo-tiny",
                 **(model_extra or {}))
    (pb / "configs" / "olmo-tiny.json").write_text(json.dumps(model))
    mix = small_mix(manifest.traffic_file("batch"))
    mix["engine"]["num_slots"] = mix["sessions"] = 2
    mix.update(mix_extra or {})
    (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cell = f"olmo-tiny.{name}"
    (pb / "limits" / f"{cell}.json").write_text(
        json.dumps({"max_logit_gap": {"limit": 1.0}}))
    bench = manifest.load(root)
    bench["configs"].append({"name": "olmo-tiny", "source": "test",
                             "file": "portbench/configs/olmo-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "olmo-tiny",
                               "traffic": name, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("decode_tok_s", "step_ms.batch"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell, bench


def test_jax_loaded_after_the_window_gives_no_result(tmp_path, monkeypatch):
    """A per-layer reader that loads ``jax`` (here a stub package) runs
    after the window closed: the run exits without a result."""
    root, pb = _checkout(tmp_path)
    cell, bench = _tiny_batch_cell(root, pb, "tiny-batch")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (pb / "metrics" / "loads.jax.py").write_text(
        "def read(run):\n    import jax  # noqa: F401\n    return 1.0\n")
    bench["per_layer"].append({"name": "loads.jax", "unit": "n",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine", "moves": "decode_tok_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.problems(bench, root) == []
    monkeypatch.syspath_prepend(str(stub.parent))
    import run
    try:
        with pytest.raises(SystemExit) as e:
            run.execute(cell, 5, 0.3, True, torch.device("cpu"), root=root)
        assert e.value.code == 3
    finally:
        sys.modules.pop("jax", None)


def test_engine_options_are_passed_whole(tmp_path):
    """A mix's engine options reach ``ServeEngine`` as the mix gives
    them; one it does not take, or one the harness sets, is refused."""
    from harness.serve import Serve, engine_options
    with pytest.raises(SystemExit):
        engine_options({"num_slots": 2, "no_such_option": 1})
    with pytest.raises(SystemExit):
        engine_options({"num_slots": 2, "faults": None})
    root, pb = _checkout(tmp_path)
    extra = {"prefix": {"groups": 1, "len": {"dist": "fixed", "value": 16}}}
    cell, bench = _tiny_batch_cell(root, pb, "tiny-prefix", extra)
    mix = manifest.traffic_file("tiny-prefix", root)
    mix["engine"].update(paged=True, page_len=8, prefix_reuse=True)
    (pb / "traffic" / "tiny-prefix.json").write_text(json.dumps(mix))
    import run
    out = run.execute(cell, 7, 0.5, False, torch.device("cpu"), root=root)
    assert out["correct"], out
    ctx = types.SimpleNamespace(
        cell=manifest.workload(bench, cell), root=root, seed=7, seconds=0.5,
        model=manifest.config_file(bench, "olmo-tiny", root), mix=mix,
        trace=False, device=torch.device("cpu"), scratch=str(tmp_path))
    drv = Serve(ctx)
    drv.setup()
    drv.window()
    assert drv.eng.prefix_reuse and drv.eng.page_len == 8
    assert drv.eng.prefix_reuse_report()["hit_requests"] > 0


def test_a_mix_may_bring_its_own_generator(tmp_path):
    """``portbench/traffic/<mix>.py``, where it exists, makes the mix."""
    root, pb = _checkout(tmp_path)
    cell, bench = _tiny_batch_cell(root, pb, "tiny-own")
    (pb / "traffic" / "tiny-own.py").write_text(
        "from harness import traffic\n\n\n"
        "def requests(mix, vocab, seed, seconds):\n"
        "    out = traffic.serve_requests(mix, vocab, seed, seconds)\n"
        "    return [dict(r, max_new_tokens=5) for r in out]\n")
    (pb / "metrics" / "budget.own.py").write_text(
        "def read(run):\n"
        "    return float(max(s['max_new_tokens'] for s in run.driver.specs))\n")
    bench["per_layer"].append({"name": "budget.own", "unit": "tokens",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine", "moves": "decode_tok_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    import run
    out = run.execute(cell, 3, 0.3, True, torch.device("cpu"), root=root)
    assert out["correct"], out
    assert out["metrics"]["budget.own"]["value"] == 5


def test_a_configuration_finds_its_reference_by_name(tmp_path, monkeypatch):
    """A configuration naming a new module of ``portbench/reference/``
    is judged by that module."""
    import reference
    root, pb = _checkout(tmp_path)
    (pb / "reference" / "tinyref.py").write_text(
        "from reference.decoder import *  # noqa: F401,F403\n"
        "from reference import decoder\n\n"
        "CALLS = []\n\n\n"
        "def logits_at(*a, **kw):\n"
        "    CALLS.append(1)\n"
        "    return decoder.logits_at(*a, **kw)\n")
    cell, bench = _tiny_batch_cell(
        root, pb, "tiny-ref",
        model_extra={"reference": "portbench/reference/tinyref.py"})
    assert manifest.problems(bench, root) == []
    monkeypatch.setattr(reference, "__path__",
                        [str(pb / "reference")] + list(reference.__path__))
    import run
    out = run.execute(cell, 4, 0.3, False, torch.device("cpu"), root=root)
    assert out["correct"], out
    from reference import tinyref
    assert tinyref.CALLS
    bad = dict(bench["configs"][-1], file="portbench/configs/bad.json")
    (pb / "configs" / "bad.json").write_text(json.dumps(dict(
        small_model("olmo-1b"), reference="src/elsewhere.py")))
    assert manifest.problems(dict(bench, configs=bench["configs"][:-1]
                                  + [bad]), root)
    sys.modules.pop("reference.tinyref", None)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORTBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_module_imports_the_jax_package(path):
    tops = manifest.top_level(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "reference" in path.parts:
        assert "repro_torch" not in tops, tops


def test_top_level_names_are_compared_whole():
    assert manifest.forbidden_loaded(["repro_torch", "repro_torch.serve",
                                      "numpy"]) is None
    assert manifest.forbidden_loaded(["repro.serve"]) == ["repro"]
    assert manifest.forbidden_loaded(["jax._src"]) == ["jax"]
