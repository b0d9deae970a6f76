"""Time full-width olmo-1b decode steps, greedy and sampled, of several
source trees on one card, each tree in a process of its own, in the
order given.

Each TREE is a checkout holding ``src/repro_torch`` and ``chip_smoke.py``
(this repo, or an unpacked ``git archive`` of another commit).  A tree's
run builds its kernels (``chip_smoke.card_and_build``), makes one olmo-1b
engine (4 slots, sparsity 0.5, seed 0, K1 on every projection and the
head) and a second one on the same weights, and serves
``chip_smoke.py``'s phase-13 trace (8 seeded Poisson requests, every
other one sampled at T 0.8 / top-k 0 or T 1.0 / top-k 40) through
``chip_smoke.serve``: all greedy on the second engine, then as given on
the first.  It reports the wall ms per decode step of each.  Compare
two trees only within one call, in the order A, B, B, A.

Run:  python tools/ab_sampled_serve.py [--out FILE] TREE [TREE ...]

Prints one line per run and writes the records, with the card's name
and power limit, to FILE (default ``chiprun_out/ab_sampled_serve.json``).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: (temperature, top-k) of the sampled requests, in turn; None: greedy
#: (``chip_smoke.SAMPLED``, kept here for trees that predate it)
SAMPLED = ((0.8, 0), None, (1.0, 40), None)


def trace(vocab: int, n: int = 8) -> list:
    """Phase 13's trace (``chip_smoke.sampled_trace``)."""
    from repro_torch.serve import poisson_trace
    out = poisson_trace(n, rate=0.5, seed=0, vocab_size=vocab,
                        prompt_len=(1, 4), max_new=(8, 24))
    for i, spec in enumerate(out):
        knob = SAMPLED[i % len(SAMPLED)]
        if knob is not None:
            spec.update(temperature=knob[0], top_k=knob[1], seed=900 + i)
    return out


def child(tree: str) -> int:
    """One tree's run: its record as the last line of stdout."""
    root = Path(tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine
    assert Path(chip_smoke.__file__).resolve().parent == root
    chip_smoke.card_and_build()
    cfg = get_config("olmo-1b")
    dev = torch.device("cuda")
    eng = ServeEngine(cfg, num_slots=4, max_len=256, sparsity=0.5, seed=0,
                      device=dev)
    greedy_eng = ServeEngine(cfg, num_slots=4, max_len=256,
                             params=eng.params,
                             head_sparsity=eng.head_sparsity, device=dev)
    sampled = trace(cfg.vocab_size)
    greedy = [{k: v for k, v in spec.items()
               if k not in ("temperature", "top_k", "seed")}
              for spec in sampled]
    out = {}
    # one pass per engine: an engine's ``wall_s`` runs from its first
    # ``run()`` on, across whatever runs after it
    for key, e, tr in (("greedy_ms", greedy_eng, greedy),
                       ("sampled_ms", eng, sampled)):
        rep = chip_smoke.serve(e, tr, f"{tree} {key[:-3]}")
        out[key] = 1e3 * rep["wall_s"] / e.decode_steps
        out[key[:-3] + "_steps"] = e.decode_steps
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "ab_sampled_serve.json"))
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
        print(f"{tree}: ms per decode step greedy {rec['greedy_ms']:.2f} "
              f"({rec['greedy_steps']} steps), sampled "
              f"{rec['sampled_ms']:.2f} ({rec['sampled_steps']} steps) | "
              f"{rec['seconds']:.1f}s")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
