"""Serving CLI of the port: seeded Poisson arrivals into ``ServeEngine``
(``serve_trace``); ``serve`` is the lock-step mode.

Runs on the card by default; ``--device cpu`` takes the plain PyTorch
path (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --smoke --sparsity 0.5 --device cpu
Paged KV with shared-prefix reuse and recompute-on-preempt:
  ... --paged --page-len 8 --page-pool-tokens 64 --prefix-reuse --preempt
A seeded fault campaign under the auditor, with every artifact:
  ... --audit --chaos-seed 3 --trace-out out/trace.json \
      --events-out out/events.jsonl --metrics-out out/metrics.json \
      --traffic-out out/traffic.json
musicgen's frames frontend (per-step frame embeddings, no prompt
tokens looked up):
  ... --arch musicgen-medium --smoke --sparsity 0.5 --device cpu
Sharded serving, one process per rank (``torch.distributed.run`` sets
RANK / WORLD_SIZE / LOCAL_RANK; only rank 0 prints and writes files):
  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch olmo-1b --smoke \
      --model-parallel 2 --dist-backend gloo --device cpu
On cards, ``--dist-backend nccl`` puts rank r on cuda:LOCAL_RANK;
``gloo`` lets several ranks share the card ``--device`` names.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch.distributed as dist

from repro_torch.launch.mesh import BACKENDS, init_world
from repro_torch.serve import (FaultPlan, ServeEngine, ServeOverloaded,
                               poisson_trace)


def serve(arch: str, smoke: bool = True, batch: int = 4, steps: int = 32,
          max_len: int = 128, sparsity: float = 0.0, seed: int = 0,
          model_parallel: int = 1, device: str | None = None) -> dict:
    """Lock-step mode: ``batch`` requests at once, each decoding
    ``steps`` tokens; returns {"tokens": (batch, steps) int32,
    "tok_per_s", "report"}.  ``head_sparsity=0.0``: the whole stack and
    the head stream through the bitmap path, packed losslessly.  The
    frames frontend (musicgen) draws its per-step embeddings from the
    engine's key folded with the step counter.  ``device`` defaults to
    ``cuda`` and raises without a card."""
    eng = ServeEngine.from_arch(arch, smoke=smoke, num_slots=batch,
                                max_len=max_len, sparsity=sparsity,
                                seed=seed, model_parallel=model_parallel,
                                head_sparsity=0.0, device=device)
    return lock_step(eng, steps, seed)


def lock_step(eng: ServeEngine, steps: int, seed: int) -> dict:
    """``serve``'s run on a built engine: one request per slot, its one
    prompt token from ``np.random.default_rng(seed)``, all submitted at
    once."""
    batch = eng.num_slots
    if eng.sparsity > 0:
        print(f"serving at {eng.weight_sparsity:.2%} weight sparsity "
              f"(head compression {eng.head_compression:.2f}x)")
    rng = np.random.default_rng(seed)
    first = rng.integers(0, eng.cfg.vocab_size, (batch, 1))
    reqs = [eng.submit([int(first[b, 0])], max_new_tokens=steps)
            for b in range(batch)]
    rep = eng.run()
    tokens = np.stack([np.asarray(r.tokens, np.int32) for r in reqs])
    print(f"decoded {steps} steps x batch {batch} in {rep['wall_s']:.2f}s "
          f"({rep['tok_per_s']:.1f} tok/s)")
    return {"tokens": tokens, "tok_per_s": rep["tok_per_s"],
            "report": rep}


def serve_trace(arch: str, smoke: bool = True, slots: int = 4,
                requests: int = 8, rate: float = 0.5, max_len: int = 128,
                max_new: tuple = (8, 24), sparsity: float = 0.0,
                head_sparsity: float | None = None, seed: int = 0,
                stream_weights: bool = True, temperature: float = 0.0,
                top_k: int = 0, paged: bool = False, page_len: int = 16,
                page_pool_tokens: int | None = None,
                prefill_chunk: int = 0, prefix_reuse: bool = False,
                preempt: bool = False, max_preempts: int = 8,
                model_parallel: int = 1, kv_shards: int | None = None,
                deadline_ms: float | None = None,
                max_queue: int | None = None,
                ttft_budget_ms: float | None = None, audit: bool = False,
                faults: FaultPlan | None = None,
                trace_out: str | None = None,
                events_out: str | None = None,
                metrics_out: str | None = None,
                traffic_out: str | None = None,
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
    ``deadline_ms`` expires requests that miss their latency budget;
    ``max_queue`` / ``ttft_budget_ms`` shed arrivals under overload
    (``ServeOverloaded``: counted, not fatal); ``audit`` runs the
    step-level invariant auditor and the packed-tensor integrity scan;
    ``faults`` fires a seeded ``FaultPlan``.  ``trace_out`` /
    ``events_out`` / ``metrics_out`` / ``traffic_out`` write the Chrome
    trace, the JSONL event log, the metrics snapshot (``.prom``:
    Prometheus text) and the traffic ledger's artifact.
    ``model_parallel`` / ``kv_shards`` shard the packed stack and the
    paged KV pools over the ranks of the ``torch.distributed`` world the
    caller started (``ServeEngine``); every rank calls this alike.
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
                                max_preempts=max_preempts,
                                model_parallel=model_parallel,
                                kv_shards=kv_shards,
                                deadline_ms=deadline_ms, max_queue=max_queue,
                                ttft_budget_ms=ttft_budget_ms, audit=audit,
                                faults=faults, trace_out=trace_out,
                                events_out=events_out,
                                metrics_out=metrics_out,
                                traffic_out=traffic_out, device=device)
    prompt_len = (1, min(4, max_len))
    hi = max(1, min(max_new[1], max_len - prompt_len[1] + 1))
    lo = max(1, min(max_new[0], hi))
    trace = poisson_trace(requests, rate=rate, seed=seed,
                          vocab_size=eng.cfg.vocab_size,
                          prompt_len=prompt_len, max_new=(lo, hi))
    shed_at_submit = 0
    for spec in trace:
        try:
            eng.submit(**spec, temperature=temperature)
        except ServeOverloaded:
            # admission control said no: count it and keep the trace going
            shed_at_submit += 1
    rep = eng.run()
    for path in eng.close():
        if verbose:
            print(f"telemetry written: {path}")
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
        if eng.mesh.size > 1:
            g = eng._step_fn.stats.report()
            print(f"sharded: mesh {eng.mesh.shape} over "
                  f"{eng.mesh.backend} | packed shards {ws['shards']}, "
                  f"kv shards {eng.kv.shards if eng.page_len else 1} | "
                  f"per-rank weight bytes per step "
                  f"{ws['device_sparse_bytes_per_step']/1e6:.2f}MB | "
                  f"decode gathers {g['ms_per_call']:.2f}ms and "
                  f"{g['bytes_received_per_call']/1e6:.2f}MB received per "
                  f"step")
            for key, reason in ws["shard_fallbacks"].items():
                print(f"  shard fallback {key}: {reason}")
        tr = rep["traffic"]
        td, tp = tr["phases"]["decode"], tr["phases"]["prefill"]
        en = tr["energy"]
        print(f"traffic: decode {td['weight_bytes']/1e6:.2f}MB weights + "
              f"{(td['kv_read_bytes'] + td['kv_write_bytes'])/1e6:.2f}MB "
              f"KV over {td['steps']} steps"
              + (f", prefill {tp['weight_bytes']/1e6:.2f}MB weights over "
                 f"{tp['calls']} calls" if tp["calls"] else "")
              + f" | modeled on the paper's 28 nm accelerator: "
                f"{en['pj_per_token']/1e6:.2f}uJ/token "
                f"({en['tops_per_watt']:.2f} TOPS/W vs dense "
                f"{en['tops_per_watt_dense']:.2f})")
        cx = eng.traffic._crosscheck
        if cx is not None:
            for ph in ("decode", "prefill"):
                if ph in cx:
                    c = cx[ph]
                    lo, hi = c["tolerance"]
                    print(f"  crosscheck ({cx['dispatch']}): {ph} "
                          f"modeled-vs-counted: "
                          f"{c['modeled']['total_bytes']/1e6:.2f}MB vs "
                          f"{c['compiled_bytes']/1e6:.2f}MB (ratio "
                          f"{c['ratio']:.2f}, band [{lo:g}, {hi:g}] "
                          f"{'ok' if c['within_band'] else 'VIOLATED'})")
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
        lc = rep["lifecycle"]
        shed = lc["shed"] + shed_at_submit
        if lc["cancelled"] or lc["expired"] or shed:
            print(f"lifecycle: {lc['cancelled']} cancelled / "
                  f"{lc['expired']} expired / {shed} shed "
                  f"({lc['wasted_tokens']} tokens wasted)")
        if lc["quarantined"]:
            print(f"  quarantined tensors: "
                  f"{', '.join(sorted(lc['quarantined']))}")
        if "faults" in lc:
            fs = lc["faults"]
            print(f"fault injection: {fs['fired']}/{fs['planned']} "
                  f"faults fired (seed {fs['seed']})")
        if "audit" in lc:
            au = lc["audit"]
            print(f"audit: {au['steps_checked']} steps checked, "
                  f"{au['integrity_scans']} integrity scans over "
                  f"{au['checksummed_tensors']} tensors, 0 violations")
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
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget from arrival-due to "
                         "completion; misses end EXPIRED (typed "
                         "DeadlineExceeded in request.result())")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="shed arrivals once this many requests are "
                         "queued (typed ServeOverloaded; counted in "
                         "report()['lifecycle'])")
    ap.add_argument("--ttft-budget-ms", type=float, default=None,
                    help="shed arrivals when estimated TTFT exceeds this "
                         "budget (queue work / measured step rate)")
    ap.add_argument("--audit", action="store_true",
                    help="run the step-level invariant auditor + packed-"
                         "tensor integrity scan every step (corruption "
                         "quarantines to dense + replay)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a seeded FaultPlan.chaos() fault schedule "
                         "(page squeezes, forced preempts, eviction "
                         "storms, NaN logits, bitflips); implies --audit")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (step-phase + "
                         "per-request spans; open in ui.perfetto.dev or "
                         "chrome://tracing)")
    ap.add_argument("--events-out", default=None,
                    help="write the structured JSONL event log "
                         "(lifecycle transitions, fallbacks, faults, "
                         "audit violations)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a metrics snapshot at exit: Prometheus "
                         "text if the path ends in .prom, else JSON")
    ap.add_argument("--traffic-out", default=None,
                    help="write the memory-traffic artifact at exit "
                         "(per-role HBM ledger, per-phase byte counters, "
                         "energy + H100 roofline projection)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="shard the packed stack and the head over this "
                         "many ranks of the torch.distributed world (the "
                         "model axis of the largest mesh that divides it)")
    ap.add_argument("--kv-shards", type=int, default=None,
                    help="shard the paged KV pools over the mesh's data "
                         "axis (default: its extent)")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="collectives of a world of several ranks (started "
                         "by torch.distributed.run): nccl, one card per "
                         "rank, or gloo (through host memory; several "
                         "ranks may share a card or run on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    faults = (FaultPlan.chaos(seed=args.chaos_seed)
              if args.chaos_seed is not None else None)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = args.device
    if world > 1:
        if args.dist_backend is None:
            ap.error(f"a world of {world} ranks needs --dist-backend "
                     f"(nccl or gloo)")
        device = str(init_world(args.dist_backend, args.device))
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    def out(path):
        return path if rank0 else None

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
                max_preempts=args.max_preempts,
                model_parallel=args.model_parallel,
                kv_shards=args.kv_shards,
                deadline_ms=args.deadline_ms, max_queue=args.max_queue,
                ttft_budget_ms=args.ttft_budget_ms,
                audit=args.audit or faults is not None, faults=faults,
                trace_out=out(args.trace_out),
                events_out=out(args.events_out),
                metrics_out=out(args.metrics_out),
                traffic_out=out(args.traffic_out),
                device=device, seed=args.seed, verbose=rank0)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
