"""Time the full-width olmo-1b train step of several source trees on one
card, each tree in a process of its own, in the order given.

Each TREE is a checkout holding ``src/repro_torch`` and ``chip_smoke.py``
(this repo, or an unpacked ``git archive`` of another commit).  A tree's
run is ``chip_smoke.train_full_width`` of that tree (phase 8a: seeded
init, ``global_l1_prune(0.5)``, AdamW with masks; 10 steps at batch 4 x
512, 2 of them warm-up and 2 profiled, then 2 at 4 x 2048, the first
warm-up), so what is timed is the tree's own training path and
nothing of the others.  Name a tree twice to see the spread between
runs; compare two trees only within one call, in the order
A, B, B, A.

Run:  python tools/ab_train_step.py [--out FILE] TREE [TREE ...]

Prints one line per run and writes the records, with the card's name
and power limit, to FILE (default ``chiprun_out/ab_train_step.json``).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("ms_per_step", "range_ms", "fwd_bwd_ms", "update_share",
        "max_memory_gib", "idle_share", "busy_ms_per_step")


def child(tree: str) -> int:
    """One tree's run: its record as the last line of stdout."""
    root = Path(tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    assert Path(chip_smoke.__file__).resolve().parent == root
    cfg = get_config("olmo-1b")
    _, _, rec = chip_smoke.train_full_width(
        cfg, torch.device("cuda"), steps=10, warm=2, profiled=2,
        long_steps=2)
    out = {k: rec.get(k) for k in KEYS}
    out["long_seq"] = {k: rec["long_seq"].get(k) for k in KEYS}
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "ab_train_step.json"))
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    runs = []
    for tree in args.trees:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, __file__, "--child", tree],
                           capture_output=True, text=True, timeout=600)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
            return p.returncode
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        rec.update(tree=tree, seconds=time.perf_counter() - t0)
        runs.append(rec)
        ls = rec["long_seq"]
        print(f"{tree}: 4x512 step {rec['ms_per_step']:.2f} ms (range "
              f"{rec['range_ms'][0]:.2f}-{rec['range_ms'][1]:.2f}), forward"
              f" + backward {rec['fwd_bwd_ms']:.2f} ms, peak "
              f"{rec['max_memory_gib']:.3f} GiB, idle share "
              f"{rec['idle_share']} | 4x2048 step {ls['ms_per_step']:.2f} "
              f"ms, forward + backward {ls['fwd_bwd_ms']:.2f} ms, peak "
              f"{ls['max_memory_gib']:.3f} GiB | {rec['seconds']:.1f}s")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
