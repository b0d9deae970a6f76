"""Readings that set a cell's correctness limits: the program's, the
control's, and for a training cell its faults', on several seeds.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 --seconds 10

Serving cell: per seed, the cell's set-up and a window of ``--seconds``
(the program's reading, as a run takes it), then at the same positions
the gap of the token that the reference computed in float8 puts first
(the control).  Training cell: per seed, the program's set-up steps
against the reference (the program's readings), the reference in
float8 against it (the control), the reference with half of each batch
left out, the mean over the rest (a fault), and without its mask
products (a fault: the pruned weights move).  One JSON line per
seed on standard output.  The benchmark's runs do not run this.
"""
import argparse
import json
import pathlib
import sys
import time
import types

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))


def serve_seed(cell, seed, seconds, device, root=ROOT, model=None,
               mix=None):
    from harness import judge, manifest
    from harness.serve import Serve
    bench = manifest.load(root)
    w = manifest.workload(bench, cell)
    model = model or manifest.config_file(bench, w["config"], root)
    mix = mix or manifest.traffic_file(w["traffic"], root)
    ctx = types.SimpleNamespace(cell=w, model=model, mix=mix, seed=seed,
                                seconds=seconds, trace=False, device=device,
                                root=root,
                                scratch=str(root / ".portbench" / "run"))
    drv = Serve(ctx)
    drv.setup()
    drv.window()
    held = drv.release()
    r = judge.serve_readings(model, seed, held["samples"], device,
                             control=True)
    keys = ("max_logit_gap", "max_logit_err", "max_served_err")
    return {"seed": seed,
            "program": {k: r[k] for k in keys if k in r},
            "control": {k: r["control_" + k] for k in keys
                        if "control_" + k in r},
            "judged_tokens": r["judged_tokens"]}


def train_seed(cell, seed, device, root=ROOT, model=None, mix=None):
    import torch
    from harness import judge, manifest
    from harness.train import Train
    from reference import train as ref_train
    bench = manifest.load(root)
    w = manifest.workload(bench, cell)
    model = model or manifest.config_file(bench, w["config"], root)
    mix = mix or manifest.traffic_file(w["traffic"], root)
    ctx = types.SimpleNamespace(cell=w, model=model, mix=mix, seed=seed,
                                seconds=0, trace=False, device=device)
    drv = Train(ctx)
    drv.setup()
    held = drv.release()
    drv.batch_index = 0
    batches = [tuple(drv._batch().values())
               for _ in range(mix["check_steps"])]

    def reference(quant=None, half=False, masked=True, first_ref=None,
                  keep_first=False):
        ref = judge.reference_weights(model, seed, device, head="tied")
        use = [(t[:t.shape[0] // 2], g[:g.shape[0] // 2]) if half else (t, g)
               for t, g in batches]
        res = ref_train.train(ref["params"], model, mix["opt"], use, quant,
                              masked, first_ref, keep_first)
        del ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return res

    # the reference against the program's first gradient, and kept as
    # the base the control and the faults are read against
    base = reference(first_ref=held.pop("first_grad_vec"), keep_first=True)
    keys = ("loss_gap", "grad_norm_gap", "grad_gap", "grad_vec_gap",
            "change_gap", "zeros_gap")
    rd = judge.train_readings(held, base)
    out = {"seed": seed, "program": {k: rd[k] for k in keys}}
    first = base.pop("first_grad_vec")
    for name, kw in (("control", {"quant": "fp8"}),
                     ("half_batch", {"half": True}),
                     ("unmasked", {"masked": False})):
        # the variant in the program's place: its gaps from the base,
        # its first gradient's difference taken against the base's
        var = reference(first_ref=first, **kw)
        rd = judge.train_readings(var, dict(
            base, first_grad_diff=var["first_grad_diff"]))
        out[name] = {k: rd[k] for k in keys}
    out["unchanged_state"] = {"change_gap": 1.0}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    import torch
    from harness import manifest
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = manifest.load(ROOT)
    mix = manifest.traffic_file(
        manifest.workload(bench, args.workload)["traffic"], ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if mix["kind"] == "serve":
            rec = serve_seed(args.workload, seed, args.seconds, device)
        else:
            rec = train_seed(args.workload, seed, device)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
