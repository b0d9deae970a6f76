"""Memory-traffic observatory: per-tensor HBM attribution and
energy-projected serving metrics.

Port of ``repro/serve/traffic.py``:

* **Ledger** — modeled HBM bytes decomposed into a (tensor-role ×
  phase) ledger: attention q/k/v/o, MLP, MoE router/expert stacks, SSM
  mixers, LM head, plus KV page reads/writes and prefix-reuse savings.
  Role rows reuse the manifest's *exact* per-entry accounting
  (``int(round(bytes × activated_scale))``), so the ledger sums to the
  ``weight_stream`` aggregates to the byte.  Per-phase byte counters
  live in the engine's ``MetricsRegistry`` and, with ``--trace-out``,
  are emitted as Chrome trace counter tracks (``hbm.decode`` /
  ``hbm.prefill``).

* **Cross-check** — the reference lowers its jitted steps and counts
  the compiled HLO's bytes.  The port runs eager torch and has no HLO
  to read, so ``crosscheck()`` records the dispatch and the reason in
  place of the compiled counts (``modeled_executed`` still gives the
  bytes the chosen dispatch should fetch).

* **Energy + roofline projection** — the ledger projects through the
  port's copy of ``core/energy.energy_dataflow`` into pJ/token and
  TOPS/W figures (the paper's 28 nm event model, Table I constants: a
  model of the paper's accelerator, not of the card) and each phase
  lands on the H100's roofline (``launch/roofline.roofline``).

The ledger is always on (host integer arithmetic in the registry); the
*artifact* (``traffic_out``) and the trace counter tracks engage only
when asked for.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.energy import NUM_MACS, energy_dataflow, tops_per_watt
from repro_torch.launch.roofline import roofline
from repro_torch.models.model import attn_capacity
from repro_torch.serve.packed import (ROUTED_EXPERT, activated_scale,
                                      entry_device_bytes)

__all__ = ["TrafficLedger", "role_of", "TRAFFIC_PHASES", "TRAFFIC_KINDS",
           "CROSSCHECK_BANDS"]

#: the ledger's phase × kind counter grid (registry names
#: ``traffic.<phase>.<kind>_bytes``)
TRAFFIC_PHASES = ("decode", "prefill")
TRAFFIC_KINDS = ("weight", "kv_read", "kv_write")

#: why ``crosscheck()`` has no compiled counts in the port
NO_HLO = ("no compiled HLO to count: the port's steps run eager torch "
          "(the reference lowers its jitted steps through XLA)")

_F32 = 4          # bytes per float32 element: params and the dense head

_ATTN_ROLES = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv",
               "wo": "attn.wo"}
_SSM_COMPS = {"mamba", "rwkv", "rwkv_cm"}

#: the reference's per-phase compiled-vs-modeled bytes ratio bands
#: (``modeled_executed`` is a fetch floor, so the lower bound is 1.0).
#: The port has no compiled program to hold to them yet.
CROSSCHECK_BANDS = {"decode": (1.0, 8.0), "prefill": (1.0, 24.0)}


def role_of(path: str) -> str:
    """Map a manifest path (``blocks/{b}/{comp}/{name}``) to its ledger
    role — the (tensor × layer-role) axis of the attribution."""
    _, _, comp, name = path.split("/")
    if name == "norm":
        return "norm"
    if comp == "attn":
        return _ATTN_ROLES.get(name, "attn.other")
    if comp == "mlp":
        return "mlp"
    if comp == "moe":
        if name == "router":
            return "moe.router"
        if (comp, name) in ROUTED_EXPERT:
            return "moe.experts"
        return "moe.other"
    if comp in _SSM_COMPS:
        return "ssm"
    return "other"


class TrafficLedger:
    """Per-role / per-phase HBM traffic attribution over one engine.

    Holds no model state of its own: role rows are recomputed lazily
    from the live manifest (quarantines call ``invalidate()``), KV
    geometry is precomputed from the config, and the running per-phase
    byte counters are ordinary registry ``Counter``s.
    """

    def __init__(self, engine) -> None:
        self.eng = engine
        cfg = engine.cfg
        itemsize = getattr(torch, cfg.compute_dtype).itemsize
        # one token's K+V line for one pattern block, across all periods
        # (the same constant paging.py sizes its pools with)
        line = (2 * cfg.num_periods * cfg.num_kv_heads
                * cfg.resolved_head_dim * itemsize)
        self._attn: List[Tuple[int, int]] = [
            (attn_capacity(blk, engine.max_len), line)
            for blk in cfg.pattern if blk.mixer == "attn"]
        self._line_total = sum(ln for _, ln in self._attn)
        self._roles: Optional[Dict[str, Dict[str, int]]] = None
        self._crosscheck: Optional[Dict] = None
        self._c: Dict[Tuple[str, str], object] = {}

    def register_metrics(self, reg) -> None:
        for phase in TRAFFIC_PHASES:
            for kind in TRAFFIC_KINDS:
                self._c[(phase, kind)] = reg.counter(
                    f"traffic.{phase}.{kind}_bytes",
                    help=f"modeled {kind} HBM bytes, {phase} phase")

    # ------------------------------------------------------------ ledger ----

    def invalidate(self) -> None:
        """Drop the cached role rows — called after a quarantine flips a
        manifest entry to dense, so the next render re-walks the live
        manifest."""
        self._roles = None

    def per_role(self) -> Dict[str, Dict[str, int]]:
        """Modeled per-step weight-HBM bytes by ledger role.

        Reuses the manifest's per-entry accounting verbatim — the same
        ``int(round(bytes × activated_scale))`` per tensor that
        ``PackedModel.stream_report`` sums, grouped by role instead of
        flattened — so the role rows sum *exactly* to the
        ``weight_stream`` aggregates (the dense-baseline walk mirrors
        ``ServeEngine.weight_stream_report`` the same way).  The
        ``device_*`` columns apply ``packed.entry_device_bytes``; on one
        device they equal the plain columns."""
        if self._roles is not None:
            return self._roles
        eng = self.eng
        cfg = eng.cfg
        activated = (eng.num_slots * cfg.top_k
                     if cfg.num_experts else None)
        roles: Dict[str, Dict[str, int]] = {}

        def add(role: str, sparse: int, dense: int,
                dev_sparse: Optional[int] = None,
                dev_dense: Optional[int] = None) -> None:
            row = roles.setdefault(
                role, {"sparse_bytes": 0, "dense_bytes": 0,
                       "device_sparse_bytes": 0, "device_dense_bytes": 0,
                       "tensors": 0})
            row["sparse_bytes"] += sparse
            row["dense_bytes"] += dense
            row["device_sparse_bytes"] += (
                sparse if dev_sparse is None else dev_sparse)
            row["device_dense_bytes"] += (
                dense if dev_dense is None else dev_dense)
            row["tensors"] += 1

        if eng.packed is not None:
            for e in eng.packed.manifest:
                scale = activated_scale(e.experts, activated)
                add(role_of(e.path),
                    int(round(e.sparse_bytes * scale)),
                    int(round(e.dense_bytes * scale)),
                    entry_device_bytes(e, "sparse_bytes", activated),
                    entry_device_bytes(e, "dense_bytes", activated))
        else:
            for bname, bdict in eng.params["blocks"].items():
                for comp, tensors in bdict.items():
                    for name, leaf in tensors.items():
                        b = leaf.numel() * leaf.element_size()
                        routed = (leaf.shape[1]
                                  if (comp, name) in ROUTED_EXPERT
                                  and leaf.dim() == 4 else 0)
                        sb = int(round(
                            b * activated_scale(routed, activated)))
                        add(role_of(f"blocks/{bname}/{comp}/{name}"),
                            sb, sb)
        head_dense = cfg.d_model * cfg.vocab_size * _F32
        head_sparse = (eng.lm_weight.hbm_bytes
                       if eng.lm_weight is not None else head_dense)
        add("head", head_sparse, head_dense)
        self._roles = roles
        return roles

    def _totals(self) -> Tuple[int, int, int]:
        """(sparse, dense, stack-only sparse) per-step weight bytes."""
        roles = self.per_role()
        sparse = sum(r["sparse_bytes"] for r in roles.values())
        dense = sum(r["dense_bytes"] for r in roles.values())
        return sparse, dense, sparse - roles["head"]["sparse_bytes"]

    # ------------------------------------------------------- step hooks ----

    def on_decode(self, positions: Sequence[int]) -> Dict[str, int]:
        """Account one decode step: the full weight stream (stack +
        head) plus per-slot KV line reads up to each live position and
        one line write per decoding slot.  Returns the step's byte
        deltas for the trace counter track."""
        weight, _, _ = self._totals()
        read = 0
        for p in positions:
            for cap, line in self._attn:
                read += min(p + 1, cap) * line
        write = len(positions) * self._line_total
        self._c[("decode", "weight")].inc(weight)
        self._c[("decode", "kv_read")].inc(read)
        self._c[("decode", "kv_write")].inc(write)
        return {"weight_bytes": weight, "kv_read_bytes": read,
                "kv_write_bytes": write}

    def on_prefill(self, pos: Sequence[int],
                   lens: Sequence[int]) -> Dict[str, int]:
        """Account one batched prefill call: the stack streams once (no
        head in the prefill step), each active lane writes ``len`` KV
        lines and attends over its whole resident prefix."""
        _, _, stack = self._totals()
        read = write = 0
        for p, n in zip(pos, lens):
            n = int(n)
            if n <= 0:
                continue
            write += n * self._line_total
            end = int(p) + n
            for cap, line in self._attn:
                read += min(end, cap) * line
        self._c[("prefill", "weight")].inc(stack)
        self._c[("prefill", "kv_read")].inc(read)
        self._c[("prefill", "kv_write")].inc(write)
        return {"weight_bytes": stack, "kv_read_bytes": read,
                "kv_write_bytes": write}

    # ------------------------------------------------------- projections ----

    def _phase_bytes(self, phase: str) -> Dict[str, int]:
        return {f"{k}_bytes": self._c[(phase, k)].value
                for k in TRAFFIC_KINDS}

    def _energy(self) -> Dict[str, float]:
        """pJ/token + TOPS/W under the 28 nm event model.  MACs per
        token = activated dense weight elements (every touched element
        multiplies once per token); the SRAM term is the measured
        per-token traffic once steps have run, else the modeled
        per-step stream amortised over the batch."""
        eng = self.eng
        sparse, dense, _ = self._totals()
        macs = dense // _F32
        tokens = eng._c_slot_steps.value
        if tokens > 0:
            w_bytes = sum(self._c[(ph, "weight")].value
                          for ph in TRAFFIC_PHASES)
            kv_bytes = sum(self._c[(ph, k)].value
                           for ph in TRAFFIC_PHASES
                           for k in ("kv_read", "kv_write"))
            w_tok = w_bytes / tokens
            kv_tok = kv_bytes / tokens
        else:
            w_tok = sparse / max(eng.num_slots, 1)
            kv_tok = float(self._line_total)
        w_tok_dense = w_tok * (dense / sparse) if sparse else w_tok
        cycles = macs / NUM_MACS
        e_s = energy_dataflow(macs, w_tok + kv_tok, cycles)
        e_d = energy_dataflow(macs, w_tok_dense + kv_tok, cycles)
        return {
            "macs_per_token": int(macs),
            "pj_per_token": e_s / 1e-12,
            "pj_per_token_dense": e_d / 1e-12,
            "tops_per_watt": tops_per_watt(macs, e_s),
            "tops_per_watt_dense": tops_per_watt(macs, e_d),
        }

    def _roofline(self) -> Dict[str, Dict]:
        """Place each phase on the H100's roofline: measured per-step
        bytes (modeled per-step stream before any step has run) against
        the phase's useful FLOPs; one card, so no collective term."""
        eng = self.eng
        sparse, dense, stack_sparse = self._totals()
        roles = self.per_role()
        macs_tok = dense / _F32
        stack_dense = (dense - roles["head"]["dense_bytes"])
        out: Dict[str, Dict] = {}
        dec = eng._c_decode_steps.value
        if dec > 0:
            b = sum(self._phase_bytes("decode").values()) / dec
        else:
            b = float(sparse + eng.num_slots * self._line_total)
        out["decode"] = roofline(2.0 * macs_tok * eng.num_slots, b, 0.0)
        pre = eng._c_prefill_steps.value
        if pre > 0:
            pb = sum(self._phase_bytes("prefill").values()) / pre
            tok_per_call = (
                self._c[("prefill", "kv_write")].value
                / (self._line_total * pre) if self._line_total else
                float(eng.prefill_chunk * eng.num_slots))
            pf = 2.0 * (stack_dense / 4.0) * tok_per_call
            out["prefill"] = roofline(pf, pb, 0.0)
        return out

    # -------------------------------------------------------- crosscheck ----

    def _dispatch(self) -> str:
        """Which weight path the step actually fetches: the bitmap
        kernels on the card ("cuda"), the pack-time dense renderings of
        the plain version on the CPU (the reference's name for it,
        "xla-oracle"), or dense params."""
        eng = self.eng
        if eng.packed is None:
            return "dense"
        if any(bw.dense_cache is not None
               for _, bw in eng.packed.leaves()):
            return "xla-oracle"
        return "cuda"

    def modeled_executed(self, phase: str) -> Dict[str, int]:
        """Bytes the step *should* fetch, by component.

        Weights follow the dispatch (DESIGN_PACKED.md §6 modeled vs
        executed): the plain version on the CPU reads the pack-time dense
        renderings and capacity-dispatch MoE executes every stored
        expert, so packed leaves with a ``dense_cache`` charge full
        dense stored bytes, unscaled; the card's kernels charge the
        compressed ``hbm_bytes``; fallback leaves charge the dense
        params tensor.  KV charges the resident lines the step touches:
        the whole contiguous k/v leaves, or the padded per-slot page
        view under paging."""
        eng = self.eng
        weights = 0
        if eng.packed is not None:
            for bname, bdict in eng.packed.blocks.items():
                for comp, tensors in bdict.items():
                    for name, bw in tensors.items():
                        if bw is None:
                            leaf = eng.params["blocks"][bname][comp][name]
                            weights += leaf.numel() * leaf.element_size()
                        elif bw.dense_cache is not None:
                            weights += (bw.dense_cache.numel()
                                        * bw.dense_cache.element_size())
                        else:
                            weights += bw.hbm_bytes
        else:
            for bdict in eng.params["blocks"].values():
                for tensors in bdict.values():
                    for leaf in tensors.values():
                        weights += leaf.numel() * leaf.element_size()
        head = 0
        if phase == "decode":
            head_dense = eng.cfg.d_model * eng.cfg.vocab_size * _F32
            if eng.lm_weight is None or \
                    eng.lm_weight.dense_cache is not None:
                head = head_dense
            else:
                head = eng.lm_weight.hbm_bytes
        if eng.page_len:
            kv = sum(p.page_slots * eng.kv.page_len * p.line_bytes
                     for p in eng.kv.pools.values()) * eng.num_slots
        else:
            kv = eng.kv.reserved_kv_bytes()
        return {"weight_bytes": int(weights), "head_bytes": int(head),
                "kv_bytes": int(kv),
                "total_bytes": int(weights + head + kv)}

    def crosscheck(self) -> Dict:
        """The reference compiles the decode (and prefill) step and
        compares the HLO's counted bytes with ``modeled_executed``.  The
        port's steps are eager torch with no compiled program to count,
        so this records the dispatch, the reason and the modeled side
        per phase, and never raises.  The result is cached into
        ``report()["traffic"]["crosscheck"]`` and the ``traffic_out``
        artifact."""
        eng = self.eng
        out: Dict = {"dispatch": self._dispatch(), "reason": NO_HLO}
        phases = ["decode"] + (["prefill"] if eng.prefill_chunk else [])
        for phase in phases:
            out[phase] = {"modeled": self.modeled_executed(phase)}
        self._crosscheck = out
        return out

    # ----------------------------------------------------------- reports ----

    def report(self) -> Dict:
        """The ``report()["traffic"]`` section — ledger, KV accounting,
        phase totals, energy projection, per-phase roofline, and the
        cross-check verdict when one has been run."""
        eng = self.eng
        roles = self.per_role()
        sparse, dense, _ = self._totals()
        saved = 0
        if eng.page_len and getattr(eng, "prefix_reuse", False):
            saved = eng.kv.hit_tokens * self._line_total
        return {
            "per_role": {k: dict(v) for k, v in sorted(roles.items())},
            "weight": {
                "sparse_bytes_per_step": sparse,
                "dense_bytes_per_step": dense,
                "reduction": dense / sparse if sparse else 1.0,
                "shards": 1,
                "device_sparse_bytes_per_step": sum(
                    r["device_sparse_bytes"] for r in roles.values()),
                "device_dense_bytes_per_step": sum(
                    r["device_dense_bytes"] for r in roles.values()),
            },
            "kv": {
                "line_bytes_per_token": self._line_total,
                "read_bytes": (self._c[("decode", "kv_read")].value
                               + self._c[("prefill", "kv_read")].value),
                "write_bytes": (self._c[("decode", "kv_write")].value
                                + self._c[("prefill", "kv_write")].value),
                "prefix_saved_bytes": saved,
            },
            "phases": {
                "decode": {"steps": eng._c_decode_steps.value,
                           **self._phase_bytes("decode")},
                "prefill": {"calls": eng._c_prefill_steps.value,
                            **self._phase_bytes("prefill")},
            },
            "energy": self._energy(),
            "roofline": self._roofline(),
            "crosscheck": self._crosscheck,
        }

    def write(self, path: str) -> None:
        """Write the traffic artifact (running the cross-check first if
        it has not run), under the reference's schema."""
        if self._crosscheck is None:
            self.crosscheck()
        doc = {
            "schema": "repro.serve.traffic/v1",
            "arch": self.eng.cfg.name,
            "sparsity": float(self.eng.sparsity),
            "num_slots": int(self.eng.num_slots),
            "traffic": self.report(),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, allow_nan=False)
            f.write("\n")
