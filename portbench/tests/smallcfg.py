"""Small configurations of the benchmark's models (the port's smoke
widths) and small mixes (4 slots), so that a whole run fits a CPU test."""
import pathlib
import sys

PORTBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
for p in (str(PORTBENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402

SMOKE = {
    "olmo-1b": dict(smoke=True, d_model=64, num_layers=2, num_heads=4,
                    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
                    token_ids=256),
    "granite-moe-3b-a800m": dict(smoke=True, d_model=64, num_layers=2,
                                 num_heads=4, num_kv_heads=2, head_dim=16,
                                 d_ff=32, vocab_size=255, token_ids=255,
                                 num_experts=5, top_k=2),
}


def small_model(name: str) -> dict:
    bench = manifest.load()
    return dict(manifest.config_file(bench, name), **SMOKE[name])


def small_mix(mix: dict) -> dict:
    """The mix at a CPU test's size: 4 slots, short prompts and answers;
    everything else as the cell has it."""
    if mix["kind"] == "train":
        return dict(mix, batch=2, seq_len=32)
    e = dict(mix["engine"], num_slots=4, max_len=64, prefill_chunk=8)
    out = dict(mix, engine=e, profile_s=1)
    if mix["loop"] == "closed":
        out.update(sessions=4, backlog=4,
                   new_tokens={"dist": "fixed", "value": 24})
        if "position" in mix:
            out["position"] = {"dist": "uniform", "lo": 8, "hi": 32}
        else:
            out["prompt_len"] = {"dist": "loguniform", "lo": 4, "hi": 16}
    else:
        out.update(prompt_len={"dist": "loguniform", "lo": 4, "hi": 32},
                   new_tokens={"dist": "loguniform", "lo": 4, "hi": 24},
                   rate_per_s=4.0)
    return out
