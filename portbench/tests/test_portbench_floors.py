"""The implementation-independent floor of a bitmap product against
hand counts, and the kept counts the floors read."""
import pytest
import torch

from harness import floors, judge


def test_product_floor_is_bytes_bound_at_decode_rows():
    # 8 x 8 weight, 10 kept, 2 rows: values 20 B, positions 8 B, X and Y
    # 2 rows x (8 + 8) x 2 B = 64 B; 40 operations
    t = floors.product_floor_s(2, 8, 8, 10)
    assert t == pytest.approx(92 / floors.HBM_BYTES_PER_S)
    assert 40 / floors.BF16_FLOPS_PER_S < t


def test_product_floor_is_operation_bound_at_wide_rows():
    k = n = 4096
    kept = k * n // 2
    rows = 8192
    moved = 2 * kept + k * n / 8 + 2 * rows * (k + n)
    ops = 2 * rows * kept
    assert ops / floors.BF16_FLOPS_PER_S > moved / floors.HBM_BYTES_PER_S
    assert floors.product_floor_s(rows, k, n, kept) == pytest.approx(
        ops / floors.BF16_FLOPS_PER_S)


def test_grouped_floor_counts_each_group_once():
    # 4 experts of 8 x 8, 40 kept in all, 6 routed rows over them
    t = floors.product_floor_s(6, 8, 8, 40, groups=4)
    moved = 2 * 40 + 4 * 64 / 8 + 2 * 6 * 16
    assert t == pytest.approx(moved / floors.HBM_BYTES_PER_S)


def test_calls_floor_counts_the_rows_each_step_needed():
    kept = {floors.shape_key(1, 8, 8): [10, 20]}
    rows = {0: {"decode": 3, "prefill": 0, "slots": 4, "prefill_rows": 32,
                "top_k": 0},
            1: {"decode": 0, "prefill": 20, "slots": 4, "prefill_rows": 32,
                "top_k": 0}}
    calls = [{"step": 0, "grouped": False, "m": 4, "k": 8, "n": 8, "g": 1},
             {"step": 1, "grouped": False, "m": 32, "k": 8, "n": 8,
              "g": 1}]
    want = (floors.product_floor_s(3, 8, 8, 15)
            + floors.product_floor_s(20, 8, 8, 15))
    assert floors.calls_floor_s(calls, kept, rows) == pytest.approx(want)


def test_kept_counts_read_the_pruned_weights():
    mask = torch.tensor([[1, 0, 1, 1], [0, 0, 1, 0]], dtype=torch.float32)
    w = torch.stack([mask, 2 * mask])              # two layers, (2, 4)
    experts = torch.ones(2, 3, 2, 4)               # 2 layers, 3 experts
    experts[0, 0] = 0
    ref = {"params": {"blocks": {"b0": {
        "attn": {"wq": w, "norm": torch.ones(2, 2)},
        "moe": {"w_up": experts, "router": w}}}},
        "head": torch.tensor([[1.0, 0.0], [0.0, 0.0]])}
    model = {"top_k": 1, "num_experts": 3, "head_sparsity": 0.5,
             "reference": "portbench/reference/decoder.py"}
    k = judge.kept_counts(ref, model)
    assert k["shapes"][floors.shape_key(1, 2, 4)] == [4, 4, 4, 4]
    assert k["shapes"][floors.shape_key(3, 2, 4)] == [16, 24]
    assert k["shapes"][floors.shape_key(1, 2, 2)] == [1]
    assert k["active"] == pytest.approx(16 + 40 / 3 + 1)


def test_train_flops_follow_the_formula():
    f = floors.train_step_flops(100, 2, 4, 8, 3, 16)
    assert f == 6 * 100 * 48 + 12 * 2 * 4 * 8 * 16 * 48
