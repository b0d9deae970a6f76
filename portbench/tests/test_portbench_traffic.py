"""The traffic generator: the same seed, the same inputs; every seed the
same sizes and arrivals in another order; the cell's parameters kept."""
import numpy as np
import pytest

from harness import manifest, traffic

SERVE = ("longgen", "batch")
# an open loop as a later cell would give it (no cell of the benchmark
# has one yet): arrivals at a fixed rate over the window
OPEN = {"kind": "serve", "loop": "open",
        "engine": {"num_slots": 32, "max_len": 2048, "prefill_chunk": 64,
                   "paged": True, "page_len": 16},
        "prompt_len": {"dist": "loguniform", "lo": 32, "hi": 1024},
        "new_tokens": {"dist": "loguniform", "lo": 16, "hi": 256},
        "greedy_share": 0.5, "temperature": 0.8, "top_k": 50,
        "rate_per_s": 4.0, "shape_seed": 1, "profile_s": 3,
        "check_requests": 12}


def _mix(name):
    return OPEN if name == "open" else manifest.traffic_file(name)


@pytest.mark.parametrize("mix_name", SERVE + ("open",))
def test_serve_traffic_is_a_function_of_the_seed(mix_name):
    mix = _mix(mix_name)
    a = traffic.serve_requests(mix, 50280, 2**31 + 11, 30.0)
    b = traffic.serve_requests(mix, 50280, 2**31 + 11, 30.0)
    c = traffic.serve_requests(mix, 50280, 2**31 + 12, 30.0)
    assert a == b
    assert a != c
    for key in ("max_new_tokens", "greedy"):
        assert sorted(r[key] for r in a) == sorted(r[key] for r in c)
    # the same arrival gaps, in another order (n of the n + 1 drawn)
    gaps = [set(np.round(np.diff([0.0] + [r["due_s"] for r in x]), 9))
            for x in (a, c)]
    assert len(gaps[0] ^ gaps[1]) <= 2
    assert (sorted(len(r["prompt"]) for r in a)
            == sorted(len(r["prompt"]) for r in c))


@pytest.mark.parametrize("mix_name", SERVE + ("open",))
def test_serve_traffic_matches_the_cell(mix_name):
    mix = _mix(mix_name)
    e = mix["engine"]
    reqs = traffic.serve_requests(mix, 50280, 7, 30.0)
    lens = mix.get("position", mix.get("prompt_len"))
    for r in reqs:
        assert lens["lo"] <= len(r["prompt"]) <= lens["hi"]
        assert len(r["prompt"]) + r["max_new_tokens"] - 1 <= e["max_len"]
        assert all(0 <= t < 50280 for t in r["prompt"])
        assert r["greedy"] == (r["temperature"] == 0.0)
    if mix["loop"] == "closed":
        assert len(reqs) == mix["sessions"] + mix["backlog"]
        assert sum(r["session"] for r in reqs) == mix["sessions"]
        assert mix["sessions"] == e["num_slots"]
        assert all(r["due_s"] == 0 for r in reqs)
    else:
        assert len(reqs) == round(mix["rate_per_s"] * 30.0)
        due = [r["due_s"] for r in reqs]
        assert due == sorted(due) and 0 < due[0] and due[-1] < 30.0
        share = sum(r["greedy"] for r in reqs) / len(reqs)
        assert share == pytest.approx(mix["greedy_share"], abs=0.01)
        assert all(r["top_k"] == mix["top_k"] for r in reqs
                   if not r["greedy"])


def test_train_batches_are_a_function_of_the_seed_and_step():
    mix = manifest.traffic_file("train")
    t0, g0 = traffic.train_batch(mix, 50304, 5, 0)
    t0b, _ = traffic.train_batch(mix, 50304, 5, 0)
    t1, _ = traffic.train_batch(mix, 50304, 5, 1)
    assert t0.shape == (mix["batch"], mix["seq_len"])
    assert (t0 == t0b).all() and not (t0 == t1).all()
    assert (g0[:, :-1] == t0[:, 1:]).all() and (g0[:, -1] == -1).all()
    assert (t0[:, 1::2] == t0[:, 0::2]).all()
    # every row of every step differs
    rows = {tuple(r) for r in np.concatenate([t0, t1])}
    assert len(rows) == 2 * mix["batch"]


def test_loguniform_draws_stay_inside_their_bounds():
    r = traffic.rng(3)
    x = traffic.draw({"dist": "loguniform", "lo": 16, "hi": 64}, 10000, r)
    assert x.min() == 16 and x.max() == 64
    assert np.median(x) < 40          # log-uniform leans to the short end


def test_shared_prefixes_and_token_bands():
    """``prefix``: requests of a group share its prefix; ``tokens``:
    each request's ids lie in one band; the sizes are the seed's own."""
    mix = dict(OPEN, prefix={"groups": 3, "len": {"dist": "uniform",
                                                   "lo": 40, "hi": 60}},
               tokens={"dist": "band", "bands": 4, "width": 100,
                       "zipf_a": 1.0})
    a = traffic.serve_requests(mix, 50280, 2**31 + 5, 30.0)
    assert a == traffic.serve_requests(mix, 50280, 2**31 + 5, 30.0)
    c = traffic.serve_requests(mix, 50280, 2**31 + 6, 30.0)
    assert (sorted(len(r["prompt"]) for r in a)
            == sorted(len(r["prompt"]) for r in c))
    heads = {tuple(r["prompt"][:40]) for r in a}
    assert len(heads) == 3
    lo = mix["prompt_len"]["lo"]
    for r in a:
        own = r["prompt"][40:][-lo:]
        assert max(own) - min(own) < 100
    plain = traffic.serve_requests(OPEN, 50280, 2**31 + 5, 30.0)
    assert [r["max_new_tokens"] for r in a] == [r["max_new_tokens"]
                                                for r in plain]
