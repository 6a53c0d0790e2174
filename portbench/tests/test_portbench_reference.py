"""The plain reference against the port at a tiny float32 size on the
CPU, dense and with experts: the port's prefill (``forward_with_cache``)
over the same weights gives the reference's logits."""
from __future__ import annotations

import pytest
import torch

from portbench import reference
from portbench.model import Dims, make_params


def dims(experts: int) -> Dims:
    return Dims(vocab=128, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2,
                d_ff=96, max_seq=64, rope_theta=1e4, norm_eps=1e-6,
                n_experts=experts, top_k=2 if experts else 0)


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


def port_logits(params, dm: Dims, tokens):
    from nos_tpu_torch.models.generate import forward_with_cache, init_cache
    from nos_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab=dm.vocab, d_model=dm.d_model, n_layers=dm.n_layers,
        n_heads=dm.n_heads, n_kv_heads=dm.n_kv_heads, d_ff=dm.d_ff,
        max_seq=dm.max_seq, rope_theta=dm.rope_theta, dtype=torch.float32,
        n_experts=dm.n_experts,
        expert_capacity_factor=dm.n_experts / 2 if dm.n_experts else 1.25)
    cache = init_cache(cfg, 1, device="cpu")
    logits, _ = forward_with_cache(params, cfg, torch.tensor([tokens]), cache)
    return logits[0]


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_reference_matches_the_port(experts, theta):
    dm = dims(experts)
    dm = Dims(**{**dm.__dict__, "rope_theta": theta})
    params = f32(make_params(dm, 1234567, "cpu"))
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(dm.vocab, (40,), generator=g).tolist()
    want = port_logits(params, dm, tokens)
    got = reference.logits(params, dm, [tokens], [0])[0]
    assert got.shape == want.shape
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-5 * scale


def test_reference_starts_at_the_served_positions():
    dm = dims(0)
    params = f32(make_params(dm, 9, "cpu"))
    seq = list(range(30))
    full = reference.logits(params, dm, [seq], [0])[0]
    tail = reference.logits(params, dm, [seq, seq[:20]], [10, 19])
    assert torch.equal(tail[0], full[10:])
    assert torch.allclose(tail[1], full[19:20], atol=1e-5)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_control_moves_the_logits(quant):
    dm = dims(0)
    params = f32(make_params(dm, 9, "cpu"))
    seq = list(range(30))
    ref = reference.logits(params, dm, [seq], [0])[0]
    ctl = reference.logits(params, dm, [seq], [0], quant=quant)[0]
    d = (ctl - ref).abs().max() / ref.abs().max()
    assert 1e-4 < d < 0.5


def test_weights_follow_the_seed():
    dm = dims(4)
    a = make_params(dm, 2 ** 31 + 17, "cpu")
    b = make_params(dm, 2 ** 31 + 17, "cpu")
    c = make_params(dm, 2 ** 31 + 18, "cpu")
    assert torch.equal(a["layers"]["w_up"], b["layers"]["w_up"])
    assert not torch.equal(a["layers"]["w_up"], c["layers"]["w_up"])
    assert a["layers"]["w_up"].dtype == torch.bfloat16
    assert a["layers"]["w_router"].dtype == torch.float32
    assert a["layers"]["w_gate"].shape == (3, 4, 64, 96)
