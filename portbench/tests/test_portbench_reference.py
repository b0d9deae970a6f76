"""The reference against the program on the CPU, at the port's smoke
widths: the same pruned weights from the same dense ones, and the same
logits when the program computes in float32 (its decode steps through
the cache against the reference's full forward)."""
import copy
import dataclasses

import pytest
import torch

from harness.serve import port_config
from harness.weights import leaves, make_params
from reference import decoder
from smallcfg import small_model

CONFIGS = ("olmo-1b", "granite-moe-3b-a800m")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_prunes_as_the_program_does(name):
    from repro_torch.serve.engine import pack_lm_head
    from repro_torch.sparse.pruning import global_l1_prune
    model = small_model(name)
    cfg = port_config(model)
    dense = make_params(model, 2**31 + 3, "cpu")
    prog = global_l1_prune(dense, model["sparsity"])
    ref = decoder.prepare(copy.deepcopy(dense), model)
    for (p, a), (q, b) in zip(leaves(prog), leaves(ref["params"])):
        assert p == q
        assert torch.equal(a, b), p
    head = pack_lm_head(prog, cfg, model["head_sparsity"], cache_dense=True)
    want = (head.dense_cache if head is not None
            else prog["embed"].t())
    assert torch.equal(want, ref["head"])


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_agree_with_the_programs_decode(name):
    from repro_torch.models.model import decode_step, init_cache
    from repro_torch.serve.engine import pack_lm_head
    from repro_torch.sparse.pruning import global_l1_prune
    model = small_model(name)
    cfg = dataclasses.replace(port_config(model), compute_dtype="float32")
    dense = make_params(model, 17, "cpu")
    ref = decoder.prepare(copy.deepcopy(dense), model)
    params = global_l1_prune(dense, model["sparsity"])
    head = pack_lm_head(params, cfg, model["head_sparsity"],
                        cache_dense=True)
    tokens = torch.randint(0, model["token_ids"], (1, 24),
                           generator=torch.Generator().manual_seed(1))
    cache = init_cache(cfg, 1, 32, device="cpu")
    got = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            logits, cache = decode_step(params, cache, cfg,
                                        tokens[:, t:t + 1],
                                        torch.tensor([t]), lm_weight=head)
            got.append(logits[0])
    got = torch.stack(got)
    want = decoder.logits_at(ref, model, tokens[0].tolist(),
                             range(tokens.shape[1]), "cpu")
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


def test_float8_control_differs_from_the_reference():
    model = small_model("olmo-1b")
    ref = decoder.prepare(make_params(model, 5, "cpu"), model)
    seq = list(range(1, 30))
    a = decoder.logits_at(ref, model, seq, range(29), "cpu")
    b = decoder.logits_at(ref, model, seq, range(29), "cpu", quant="fp8")
    rel = (a - b).abs().max() / a.abs().max()
    assert 1e-3 < rel < 0.5
