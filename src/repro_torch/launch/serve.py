"""Serving CLI of the port: seeded Poisson arrivals into ``ServeEngine``.

Runs on the card by default; ``--device cpu`` takes the plain PyTorch
path (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --smoke --sparsity 0.5 --device cpu
Paged KV with shared-prefix reuse and recompute-on-preempt:
  ... --paged --page-len 8 --page-pool-tokens 64 --prefix-reuse --preempt
"""
from __future__ import annotations

import argparse

from repro_torch.serve import ServeEngine, poisson_trace


def serve_trace(arch: str, smoke: bool = True, slots: int = 4,
                requests: int = 8, rate: float = 0.5, max_len: int = 128,
                max_new: tuple = (8, 24), sparsity: float = 0.0,
                head_sparsity: float | None = None, seed: int = 0,
                stream_weights: bool = True, temperature: float = 0.0,
                top_k: int = 0, paged: bool = False, page_len: int = 16,
                page_pool_tokens: int | None = None,
                prefill_chunk: int = 0, prefix_reuse: bool = False,
                preempt: bool = False, max_preempts: int = 8,
                device: str | None = None, verbose: bool = True) -> dict:
    """Continuous-batching mode: a seeded Poisson trace into the engine.

    ``head_sparsity`` defaults to ``sparsity``; ``stream_weights=False``
    serves a fully dense-dispatch baseline (stack and head).
    ``temperature`` > 0 samples every request at that temperature
    (top-``top_k`` truncated); default greedy.  ``prefill_chunk`` > 0
    ingests prompts in chunks of that many tokens (0: the prompt walk).
    ``paged`` pages the KV cache into ``page_len``-token pages
    (``page_pool_tokens`` bounds each pool; admissions that do not fit
    queue); ``prefix_reuse`` and ``preempt`` (with ``paged``) share
    matching prompt prefixes copy-on-write and preempt the youngest slot
    when the pool runs dry (at most ``max_preempts`` times per request).
    Tokens are the same with any of them on or off.
    ``device`` defaults to ``cuda`` and raises without a card.
    """
    eng = ServeEngine.from_arch(arch, smoke=smoke, num_slots=slots,
                                max_len=max_len, sparsity=sparsity,
                                head_sparsity=head_sparsity, seed=seed,
                                stream_weights=stream_weights,
                                bitmap_head=stream_weights, top_k=top_k,
                                paged=paged, page_len=page_len,
                                page_pool_tokens=page_pool_tokens,
                                prefill_chunk=prefill_chunk,
                                prefix_reuse=prefix_reuse, preempt=preempt,
                                max_preempts=max_preempts, device=device)
    prompt_len = (1, min(4, max_len))
    hi = max(1, min(max_new[1], max_len - prompt_len[1] + 1))
    lo = max(1, min(max_new[0], hi))
    trace = poisson_trace(requests, rate=rate, seed=seed,
                          vocab_size=eng.cfg.vocab_size,
                          prompt_len=prompt_len, max_new=(lo, hi))
    for spec in trace:
        eng.submit(**spec, temperature=temperature)
    rep = eng.run()
    if verbose:
        ws = rep["weight_stream"]
        print(f"device {eng.device} | weight stream: "
              f"{ws['packed_tensors']} tensors packed, "
              f"{ws['fallback_tensors']} dense fallbacks | modeled "
              f"per-step weight bytes {ws['sparse_bytes_per_step']/1e6:.2f}"
              f"MB vs dense {ws['dense_bytes_per_step']/1e6:.2f}MB "
              f"({ws['reduction']:.2f}x)")
        if rep["head_fallback"]:
            print(f"  head fallback: {rep['head_fallback']}")
        if sparsity > 0:
            print(f"serving at {eng.weight_sparsity:.2%} weight sparsity "
                  f"(head compression {eng.head_compression:.2f}x)")
        lat, ftl = rep["latency_s"], rep["first_token_s"]
        print(f"{rep['requests']} requests / {rep['generated_tokens']} "
              f"tokens in {rep['wall_s']:.2f}s over {slots} slots "
              f"(occupancy {rep['slot_occupancy']:.0%})")
        print(f"  throughput {rep['tok_per_s']:.1f} tok/s | latency "
              f"p50 {lat['p50'] * 1e3:.1f}ms p99 {lat['p99'] * 1e3:.1f}ms "
              f"| first-token p50 {ftl['p50'] * 1e3:.1f}ms "
              f"p99 {ftl['p99'] * 1e3:.1f}ms")
        pf = rep["prefill"]
        if pf["enabled"]:
            print(f"  chunked prefill: {pf['calls']} calls of {pf['chunk']} "
                  f"tokens, {pf['tokens_prefilled']} prompt tokens "
                  f"(lane utilization {pf['lane_utilization']:.0%})")
        elif pf["fallback"]:
            print(f"  prefill fallback: {pf['fallback']}")
        pg = rep["paging"]
        if pg["paged"]:
            print(f"  paged KV: {pg['pages_peak']} peak / "
                  f"{pg['pages_total']} pool pages ({pg['page_len']} "
                  f"tokens each) | reserved KV "
                  f"{pg['reserved_kv_bytes']/1e3:.1f}kB vs contiguous "
                  f"{pg['contiguous_kv_bytes']/1e3:.1f}kB "
                  f"({pg['reserved_reduction']:.2f}x)")
        elif pg["fallback"]:
            print(f"  paging fallback: {pg['fallback']}")
        pr = rep["prefix_reuse"]
        if pr["enabled"]:
            split = ""
            if pr["hit_requests"] and pr["miss_requests"]:
                split = (f" | TTFT p50 hit "
                         f"{pr['ttft_hit_s']['p50'] * 1e3:.1f}ms vs miss "
                         f"{pr['ttft_miss_s']['p50'] * 1e3:.1f}ms")
            print(f"  prefix reuse: {pr['hits']} hits / {pr['misses']} "
                  f"misses ({pr['hit_tokens']} tokens adopted, "
                  f"{pr['forks']} COW forks, {pr['evictions']} "
                  f"evictions){split}")
        elif pr["fallback"]:
            print(f"  prefix-reuse fallback: {pr['fallback']}")
        pe = pr["preempt"]
        if pe["enabled"]:
            print(f"  preemption: {pe['count']} preempts, "
                  f"{pe['recomputed_tokens']} tokens recomputed")
        elif pe["fallback"]:
            print(f"  preempt fallback: {pe['fallback']}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per decode step (Poisson)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--head-sparsity", type=float, default=None,
                    help="LM-head prune level before bitmap packing "
                         "(default: --sparsity; 0 = exact dense head)")
    ap.add_argument("--dense-stack", action="store_true",
                    help="disable all bitmap weight streaming (stack and "
                         "head): a fully dense-dispatch baseline")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="default top-k truncation for sampled requests")
    ap.add_argument("--paged", action="store_true",
                    help="page the KV cache (fixed-size pages + per-slot "
                         "page tables; reserved bytes scale with live "
                         "tokens)")
    ap.add_argument("--page-len", type=int, default=16,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--page-pool-tokens", type=int, default=None,
                    help="bound each page pool to this many tokens "
                         "(default: worst case; smaller pools queue "
                         "admissions when pages run out)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="ingest prompts in chunks of this many tokens, one "
                         "batched call per step (0 = the prompt walk)")
    ap.add_argument("--prefix-reuse", action="store_true",
                    help="share matching prompt prefixes copy-on-write "
                         "across requests (with --paged): cache hits "
                         "skip prefill entirely")
    ap.add_argument("--preempt", action="store_true",
                    help="commit live pages only and reclaim by "
                         "preempting + recomputing the youngest slot "
                         "when the pool runs dry (with --paged)")
    ap.add_argument("--max-preempts", type=int, default=8,
                    help="preemption bound: a request preempted this many "
                         "times re-admits pinned (worst-case page "
                         "commitment, never victimized again)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    serve_trace(args.arch, smoke=args.smoke, slots=args.slots,
                requests=args.requests, rate=args.rate,
                max_len=args.max_len, sparsity=args.sparsity,
                head_sparsity=args.head_sparsity,
                stream_weights=not args.dense_stack,
                temperature=args.temperature, top_k=args.top_k,
                paged=args.paged, page_len=args.page_len,
                page_pool_tokens=args.page_pool_tokens,
                prefill_chunk=args.prefill_chunk,
                prefix_reuse=args.prefix_reuse, preempt=args.preempt,
                max_preempts=args.max_preempts, device=args.device,
                seed=args.seed)


if __name__ == "__main__":
    main()
