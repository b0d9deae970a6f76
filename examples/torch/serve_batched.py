"""Continuous-batching sparse serving with the port: a stream of requests
into the jamba-style hybrid (attention + Mamba + MoE) smoke model.

Six requests arrive over time into a 2-slot engine with 50 % pruned
weights: the scheduler admits each into the first freed slot (no drain
barrier), each slot's cache and mixer state are reset on admission, and
every projection streams in the paper's bitmap-compressed format every
step — attention, Mamba and the LM head through ``bitmap_spmm`` (K1 on
the card), the MoE expert stacks through ``bitmap_spmm_grouped`` (K1g).

The KV cache is paged (``paged=True``): attention blocks cache into
fixed-size pages gathered through per-slot page tables, so reserved
cache bytes track live tokens instead of ``num_slots × max_len``
(Mamba state stays slotted — it is O(1) per slot).

Run:  PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]
"""
import argparse

from repro_torch.serve import ServeEngine, poisson_trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a card); cpu runs "
                         "the plain versions")
    args = ap.parse_args(argv)
    eng = ServeEngine.from_arch("jamba-v0.1-52b", smoke=True, num_slots=2,
                                max_len=64, sparsity=0.5, seed=0,
                                paged=True, page_len=8, device=args.device)
    trace = poisson_trace(6, rate=0.4, seed=0,
                          vocab_size=eng.cfg.vocab_size, max_new=(8, 16))
    reqs = [eng.submit(**spec) for spec in trace]
    rep = eng.run()

    assert rep["requests"] == 6
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)
    slots_used = {r.slot for r in reqs}
    print(f"decoded {rep['generated_tokens']} tokens across "
          f"{rep['requests']} requests on {len(slots_used)} slots "
          f"({rep['tok_per_s']:.1f} tok/s, occupancy "
          f"{rep['slot_occupancy']:.0%})")
    lat = rep["latency_s"]
    print(f"latency p50 {lat['p50'] * 1e3:.1f}ms / p99 "
          f"{lat['p99'] * 1e3:.1f}ms; per-request slots: "
          f"{[r.slot for r in reqs]}")
    pg = rep["paging"]
    print(f"paged KV: peak {pg['pages_peak']} of {pg['pages_total']} "
          f"pool pages; reserved {pg['reserved_kv_bytes']/1e3:.1f}kB vs "
          f"contiguous {pg['contiguous_kv_bytes']/1e3:.1f}kB")
    print("OK")


if __name__ == "__main__":
    main()
