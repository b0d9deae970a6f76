"""Port's copy of the paper's accelerator model (``repro_torch.core``)
against the JAX package's (``repro.core``): every public function and
method on the same seeded numpy inputs, with exact equality of every
returned array, count and float.
"""
import dataclasses

import numpy as np
import pytest

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
pytest.importorskip("jax")

import repro.core as ref_core
import repro_torch.core as pt_core
from repro.core import (accelerator as ref_acc, energy as ref_energy,
                        mapm as ref_mapm, mobilenet as ref_mobilenet)
from repro_torch.core import (accelerator as pt_acc, energy as pt_energy,
                              mapm as pt_mapm, mobilenet as pt_mobilenet)

REF = {"core": ref_core, "accelerator": ref_acc, "energy": ref_energy,
       "mapm": ref_mapm, "mobilenet": ref_mobilenet}
PT = {"core": pt_core, "accelerator": pt_acc, "energy": pt_energy,
      "mapm": pt_mapm, "mobilenet": pt_mobilenet}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _sparse(shape, sparsity, seed):
    return ref_core.random_sparse(shape, sparsity, _rng(seed))


def _bitmaps(seed, lead=(3,), m=16, n=16, k=64, si=0.6, sw=0.7):
    """Seeded (input bitmaps, weight bitmaps) and their packed values."""
    x = _sparse((*lead, m, k), si, seed)
    w = _sparse((*lead, n, k), sw, seed + 1)
    return x, w


def _simulate(mods, values, compute_values, reg_size=8):
    x, w = _bitmaps(7)
    core = mods["core"]
    bx, vx, nx = zip(*(core.compress_rows(t) for t in x))
    bw, vw, nw = zip(*(core.compress_rows(t) for t in w))
    pad = max(v.shape[1] for v in vx + vw)

    def stack(vs):
        return np.stack([np.pad(v, ((0, 0), (0, pad - v.shape[1])))
                         for v in vs])
    kw = dict(nnz_i=np.stack(nx), nnz_w=np.stack(nw), reg_size=reg_size,
              compute_values=compute_values)
    if values:
        return core.simulate(np.stack(bx), np.stack(bw), stack(vx),
                             stack(vw), **kw)
    return core.simulate(np.stack(bx), np.stack(bw), **kw)


def _stats_view(s):
    return {**dataclasses.asdict(s), "sram_bytes": s.sram_bytes,
            "mapm": s.mapm, "utilization": s.utilization}


def _gemm(mods, compute_values, max_row_tiles):
    x = _sparse((40, 96), 0.5, 3)
    w = _sparse((24, 96), 0.75, 4)
    cfg = mods["core"].AcceleratorConfig(k_buffer=64, tile_batch=4)
    rep = mods["core"].run_gemm(x, w, cfg, compute_values=compute_values,
                                max_row_tiles=max_row_tiles, seed=5)
    en = rep.energy
    return {"report": dataclasses.asdict(rep), "mapm": rep.mapm,
            "utilization": rep.utilization,
            "speedup_vs_dense": rep.speedup_vs_dense,
            "sram_reduction_vs_sparten": rep.sram_reduction_vs_sparten,
            "energy": dataclasses.asdict(en), "total_j": en.total_j,
            "breakdown": en.breakdown(), "tops_per_watt": rep.tops_per_watt,
            "summary": rep.summary()}


def _energy(mods):
    e = mods["energy"]
    stats = _simulate(mods, values=False, compute_values=False)
    rep = e.energy_from_stats(stats)
    j = e.energy_dataflow(12345, 6789.5, 321.25)
    return {"report": dataclasses.asdict(rep), "total_j": rep.total_j,
            "breakdown": rep.breakdown(), "dataflow": j,
            "dataflow_pes": e.energy_dataflow(100, 10.0, 7.0, num_pes=64),
            "tops_per_watt": e.tops_per_watt(12345, j),
            "power_watts": e.power_watts(j, 321),
            "constants": [e.PJ, e.E_MAC, e.E_SRAM_BYTE, e.E_REG_BYTE,
                          e.E_EIM_PAIR, e.E_CYCLE_PE, e.CLOCK_HZ,
                          e.NUM_MACS]}


def _mapm(mods):
    m, core = mods["mapm"], mods["core"]
    x = _sparse((12, 40), 0.5, 8)
    w = _sparse((20, 40), 0.6, 9)
    counts = [core.dense_output_stationary(33, 17, 40),
              core.dense_output_stationary(33, 17, 40, tile=8),
              core.sparten(1000, 64), core.sparten(1000, 64, 0.25),
              core.scnn(1000, 300, 400)]
    return {"counts": [(dataclasses.asdict(c), c.mapm) for c in counts],
            "sparse_macs": core.sparse_macs(x, w),
            "reduction": core.reduction_vs_sparten(0.31),
            "reduction_scnn": core.reduction_vs_sparten(
                0.31, m.SCNN_PAPER_MAPM),
            "constants": [m.SPARTEN_PAPER_MAPM, m.SCNN_PAPER_MAPM]}


def _mobilenet(mods):
    layers = mods["mobilenet"].pw_layers()
    small = mods["mobilenet"].pw_layers(input_size=96)
    return [(dataclasses.asdict(p), p.gemm_macs) for p in layers + small]


def _bitmap(mods):
    core = mods["core"]
    x = _sparse((6, 20), 0.6, 1)
    vec = core.compress(x[0])
    return {"vector": (dataclasses.asdict(vec), vec.nnz, vec.k,
                       vec.decompress()),
            "rows": core.compress_rows(x),
            "mask_1d": core.mask_index(x[1] != 0),
            "mask_2d": core.mask_index(x != 0),
            "random": core.random_sparse((5, 7), 0.4, _rng(11)),
            "random_f64": core.random_sparse((3, 4), 0.5, _rng(12),
                                             dtype=np.float64),
            "prune": core.prune_global_l1(_rng(2).standard_normal(
                (9, 13)).astype(np.float32), 0.7),
            "prune_none": core.prune_global_l1(x, 0.0)}


def _eim(mods):
    core = mods["core"]
    x, w = _bitmaps(21, lead=(), m=4, n=5, k=48)
    bx, bw = x != 0, w != 0
    streams = core.eim_streams(bx, bw)
    return {"reference": core.eim_reference(bx[0], bw[1]),
            "two_step": core.eim_two_step(bx[2], bw[3]),
            "streams": dataclasses.asdict(streams)}


def _stats(mods, values, compute_values):
    s = _simulate(mods, values, compute_values)
    merged = s.merge(_simulate(mods, False, False, reg_size=4))
    return {"stats": _stats_view(s), "merged": _stats_view(merged)}


CASES = {
    "bitmap": _bitmap,
    "eim": _eim,
    "sidr.simulate": lambda mods: _stats(mods, False, False),
    "sidr.simulate(values)": lambda mods: _stats(mods, True, False),
    "sidr.simulate(compute_values)": lambda mods: _stats(mods, True, True),
    "mapm": _mapm,
    "energy": _energy,
    "accelerator.run_gemm": lambda mods: _gemm(mods, False, None),
    "accelerator.run_gemm(values, sampled)": lambda mods: _gemm(mods, True,
                                                                 2),
    "mobilenet.pw_layers": _mobilenet,
}


def _assert_equal(a, b, path="result"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for key in a:
            _assert_equal(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_core_matches_reference(case):
    _assert_equal(CASES[case](REF), CASES[case](PT))


def test_core_exports_match_reference():
    assert pt_core.__all__ == ref_core.__all__
