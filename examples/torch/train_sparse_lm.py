"""End-to-end training run of the port: an LM with the paper's sparsity
regime (global-L1 prune + masked sparse training), fault-tolerant
checkpointing included.

Two presets: ``--size 20m`` (default) finishes a few hundred steps
quickly; ``--size 100m`` is the full ~100M-param run (same code path).
Data is the deterministic synthetic stream (``repro_torch.data``);
expect the loss to drop from ~ln(V) toward the copy-structure floor.
Checkpoints go to ``--ckpt-dir`` (default: a fresh temporary directory,
removed at the end; a directory that holds checkpoints resumes).

Run:  PYTHONPATH=src python examples/torch/train_sparse_lm.py \
          [--steps 300] [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.models.config import BlockCfg, ModelConfig


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="olmo-100m",
        d_model=512, num_layers=8, num_heads=8, num_kv_heads=8,
        d_ff=2048, vocab_size=32_768,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln_nonparam", act="silu", max_seq_len=512,
    )


def model_20m() -> ModelConfig:
    return ModelConfig(
        name="olmo-100m",  # same registry id, smaller
        d_model=256, num_layers=4, num_heads=4, num_kv_heads=4,
        d_ff=1024, vocab_size=8192,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln_nonparam", act="silu", max_seq_len=512,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--size", choices=("20m", "100m"), default="20m")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a card)")
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    import repro_torch.launch.train as T
    model = model_100m() if args.size == "100m" else model_20m()
    # register the custom config through the smoke hook
    orig = C.get_smoke_config
    C.get_smoke_config = lambda a: (model if a == "olmo-100m" else orig(a))
    T.get_smoke_config = C.get_smoke_config
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_sparse_lm_")
    try:
        n = model.param_count()
        print(f"training olmo-100m ({n/1e6:.1f}M params) at "
              f"{args.sparsity:.0%} weight sparsity")
        res = T.train("olmo-100m", smoke=True, steps=args.steps,
                      batch=args.batch, seq=args.seq,
                      sparsity=args.sparsity, lr=1e-3, ckpt_dir=ckpt_dir,
                      ckpt_every=100, log_every=10, device=args.device)
    finally:
        C.get_smoke_config = T.get_smoke_config = orig
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    first, last = res["losses"][0], res["final_loss"]
    print(f"loss: {first:.3f} -> {last:.3f}")
    assert last < first - 0.5, "training failed to reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
