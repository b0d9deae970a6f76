"""What decides ``correct``: the program's outputs against the reference,
which makes the weights again from the seed and prunes them itself.

Serving: for every judged token, the gap by which the reference's logit
of the served token lies below the reference's best logit at that
position; the reading is the widest gap.  Where the program's logit
rows were kept, also each position's error of the program's logits
against the reference's (the root-mean-square difference over the
reference's spread about its mean); the reading is the largest.  And,
where the logits were kept, each position's served error: the larger
of that logit error and the served token's gap over the same spread
less twice the logit error (a token may lose a near tie by what the
program's own error at that position explains, and no more); the
reading is the largest.  Where the first choice leads by more than any
rounding moves it, the gap alone separates nothing, and this number
still catches a token altered after the logits.  The control reads
the same at the same positions for the reference computed in float8:
the gap of the token it puts first, and its logits' error.  Training:
see ``train_readings``.
"""
from __future__ import annotations

import statistics
from typing import Dict, Sequence, Tuple

import torch

from harness.floors import shape_key
from harness.manifest import reference_module
from harness.weights import make_params

def reference_weights(model: Dict, seed: int, device, head: str = "serve"):
    net = reference_module(model)
    net.no_tf32()
    return net.prepare(make_params(model, seed, device), model, head)


def kept_counts(ref: Dict, model: Dict) -> Dict:
    """Kept values of every product the program streams as a bitmap,
    keyed by shape (one entry per layer), and the kept weights one token
    meets ("active"), as the configuration's reference counts them."""
    raw = reference_module(model).kept_counts(ref, model)
    return {"shapes": {shape_key(*s): v for s, v in raw["shapes"].items()},
            "active": raw["active"]}


def _sample_logits(ref, model, sample, device, quant=None):
    ingest, served = sample[:2]
    seq = list(ingest) + list(served[:-1])
    at = range(len(ingest) - 1, len(seq))
    return reference_module(model).logits_at(ref, model, seq, at, device,
                                             quant)


def serve_readings(model: Dict, seed: int, samples: Sequence[Tuple],
                   device, control: bool = False) -> Dict:
    """The widest gap of the served tokens (and, with ``control``, of the
    float8 reference's first choices) below the reference's best."""
    ref = reference_weights(model, seed, device)
    out = {"max_logit_gap": 0.0, "judged_tokens": 0}
    for sample in samples:
        served = torch.tensor(sample[1], device=device)
        logits = _sample_logits(ref, model, sample, device)
        best = logits.max(-1).values
        gap = best - logits.gather(1, served[:, None])[:, 0]
        _widest(out, "max_logit_gap", gap.max())
        out["judged_tokens"] += served.numel()
        if sample[2] is not None:
            err = logit_error(sample[2].to(device), logits)
            _widest(out, "max_logit_err", err.max())
            _widest(out, "max_served_err", served_error(err, gap, logits))
        if control:
            low = _sample_logits(ref, model, sample, device, "fp8")
            pick = low.argmax(-1)
            cgap = best - logits.gather(1, pick[:, None])[:, 0]
            cerr = logit_error(low, logits)
            _widest(out, "control_max_logit_gap", cgap.max())
            _widest(out, "control_max_logit_err", cerr.max())
            _widest(out, "control_max_served_err",
                    served_error(cerr, cgap, logits))
    out["kept"] = kept_counts(ref, model)
    return out


def _widest(out: Dict, key: str, value) -> None:
    out[key] = max(out.get(key, 0.0), float(value))


def spread(want: torch.Tensor) -> torch.Tensor:
    """Per position (row): the RMS of the logits about their mean."""
    return (want - want.mean(-1, keepdim=True)).pow(2).mean(-1).sqrt()


def served_error(err: torch.Tensor, gap: torch.Tensor,
                 want: torch.Tensor) -> torch.Tensor:
    """The largest over positions of max(err, gap / spread - 2 err)."""
    return torch.maximum(err, gap / spread(want) - 2 * err).max()


def logit_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per position (row): RMS of got - want over ``spread(want)``."""
    return (got.float() - want).pow(2).mean(-1).sqrt() / spread(want)


def relative_gaps(prog: Dict, ref: Dict, grads: Dict,
                  base: Dict = None) -> Tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger
    of the reference's norm of that leaf and of the median leaf; leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out.  With ``base`` ({leaf: 0}), ``prog`` holds the norms
    of the differences themselves."""
    med_g = statistics.median(grads.values())
    keep = [p for p in ref if grads[p] >= 1e-3 * med_g]
    med = statistics.median(ref[p] for p in keep)
    worst, at = 0.0, ""
    for p in keep:
        r = (abs(prog[p] - (ref[p] if base is None else base[p]))
             / max(ref[p], med))
        if r > worst:
            worst, at = r, "/".join(p)
    return worst, at


def train_readings(prog: Dict, ref: Dict) -> Dict:
    """Training's numbers: the widest loss gap over the steps the
    reference follows; the first step's gap of the global gradient norm
    before clipping, over the reference's (the weights still equal, so
    only the arithmetic and the batch move it); the worst leaf's gaps of
    the first clipped gradient's norm and of the change's norm over
    those steps; the worst leaf's norm of the first clipped gradient's
    difference from the reference's, on the same scale (the reference
    takes it against the program's gradient: ``first_grad_diff``); the
    count of zeros that differ (pruned entries must stay zero)."""
    n = len(ref["losses"])
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"][:n],
                                              ref["losses"]))
    norm_gap = (abs(prog["grad_norms"][0] - ref["grad_norms"][0])
                / ref["grad_norms"][0])
    raw = ref["first_grad_raw"]
    grad_gap, grad_at = relative_gaps(prog["first_grad"], ref["first_grad"],
                                      raw)
    change_gap, change_at = relative_gaps(prog["change"], ref["change"], raw)
    zero = {p: 0.0 for p in ref["first_grad_diff"]}
    vec_gap, vec_at = relative_gaps(ref["first_grad_diff"], ref["first_grad"],
                                    raw, base=zero)
    zeros_gap = max(abs(prog["zeros"][p] - ref["zeros"][p])
                    for p in ref["zeros"])
    return {"loss_gap": loss_gap, "grad_norm_gap": norm_gap,
            "grad_gap": grad_gap, "grad_vec_gap": vec_gap,
            "change_gap": change_gap, "zeros_gap": float(zeros_gap),
            "worst_grad_leaf": grad_at, "worst_change_leaf": change_at}
