"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's weights and traffic
from the seed, sets up the program (``repro_torch``), warms up every
shape the cell uses, measures for ``--seconds`` and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit (also the last lines of standard error).
It exits non-zero, printing no result, without the cards the cell asks
for, or if the JAX package (``repro``), ``jax``, ``jaxlib`` or ``flax``
was loaded by the time the window closed, the check ran, the per-layer
readers ran or the line is printed.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))


def cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the program's own kernel library builds under its package)."""
    base = root / ".portbench" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def refuse_forbidden() -> None:
    """Exit (code 3, no result) if the JAX package or JAX is loaded."""
    from harness import manifest
    bad = manifest.forbidden_loaded(list(sys.modules))
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        raise SystemExit(3)


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            root: pathlib.Path = ROOT, t_start: float = None,
            bench=None, model=None, mix=None) -> dict:
    """One run, after the look for a chip: set-up, window, check, and
    the result object.  ``bench`` / ``model`` replace what the
    checkout's files say (tests run small configurations this way), as
    ``mix`` the cell's traffic mix."""
    import torch
    from harness import judge, manifest

    t_start = _T0 if t_start is None else t_start
    bench = bench or manifest.load(root)
    w = manifest.workload(bench, cell)
    model = model or manifest.config_file(bench, w["config"], root)
    mix = mix or manifest.traffic_file(w["traffic"], root)
    limits = manifest.limits_file(cell, root)
    ctx = types.SimpleNamespace(cell=w, model=model, mix=mix, seed=seed,
                                seconds=seconds, trace=trace, device=device,
                                root=root,
                                scratch=str(root / ".portbench" / "run"))
    if mix["kind"] == "serve":
        from harness.serve import Serve
        driver = Serve(ctx)
    else:
        from harness.train import Train
        driver = Train(ctx)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    e2e = driver.window()
    if trace and mix["kind"] == "train":
        driver.trace()
    refuse_forbidden()
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    held = driver.release()

    # ---- the check: the reference, after the program's state is freed
    if mix["kind"] == "serve":
        readings = judge.serve_readings(model, seed, held["samples"], device)
        kept = readings["kept"]
        if getattr(driver, "unanswered", 0):
            readings["unanswered"] = float(driver.unanswered)
    else:
        from reference import train as ref_train
        ref = judge.reference_weights(model, seed, device, head="tied")
        driver.batch_index = 0
        batches = [tuple(driver._batch().values())
                   for _ in range(mix["check_steps"])]
        out = ref_train.train(ref["params"], model, mix["opt"], batches,
                              first_ref=held.pop("first_grad_vec"))
        readings = judge.train_readings(held, out)
        kept = None
        del ref, batches
    # the numbers the cell's limits name, each at or under its limit; an
    # answer that never came fails whatever the limits say
    checks = {k: float(readings[k]) for k in limits}
    limit = {k: limits[k]["limit"] for k in limits}
    if readings.get("unanswered"):
        checks["unanswered"], limit["unanswered"] = readings["unanswered"], 0.0
    correct = all(checks[k] <= limit[k] for k in checks)

    result = {"correct": bool(correct), "attempted": int(driver.attempted),
              "failed": int(driver.failed)}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    if not trace:
        e2e["setup_s"] = setup_s
        names = [m["name"] for m in manifest.end_to_end(bench, cell)]
        result["metrics"] = {n: {"value": e2e[n], "unit": units[n]}
                             for n in names}
    else:
        run = types.SimpleNamespace(
            model=model, mix=mix, cell=w, driver=driver, kept=kept,
            steps=driver.steps, e2e=e2e,
            profile=(driver.profile.summary if driver.profile else None),
            calls=driver.log.calls if mix["kind"] == "serve" else [])
        vals = {}
        for m in manifest.per_layer(bench, cell):
            v = manifest.reader(m["name"], root)(run)
            if v is not None:
                vals[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = vals
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        prof = driver.profile.summary if driver.profile else None
        dev["busy_s"] = prof["busy_s"] if prof else 0.0
        dev["window_s"] = prof["window_s"] if prof else 0.0
        if prof:
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    result["device"] = dev
    result["checks"] = {k: {"value": checks[k], "limit": limit[k]}
                        for k in checks}
    # the reference and the readers ran after the window: look again
    refuse_forbidden()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    import torch
    from harness import manifest
    chips = manifest.workload(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0))
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    refuse_forbidden()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
