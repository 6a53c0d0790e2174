"""Port parity: ``nos_tpu_torch.ops.ring_attention`` and
``nos_tpu_torch.ops.ulysses`` on CPU ranks over gloo against the
reference's ``ring_attention_sharded`` / ``ulysses_attention_sharded``
on the conftest's virtual CPU devices, and against full attention.

Each sp layout's ranks run once (a module fixture): every rank takes its
sequence chunk of every case's seeded numpy q, k, v, runs the ring and
Ulysses under autograd against a seeded upstream gradient, and returns
its chunk of the output and of dq, dk, dv. The chunks, joined, agree
with the reference's sharded output and with full attention within
2e-4 (the reference's tolerance in ``tests/test_jax_plane.py`` and
``tests/test_ulysses.py``), and their gradients with the plain
unsharded attention's under autograd.
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.ops.attention import xla_attention as j_xla  # noqa: E402
from nos_tpu.ops.ring_attention import ring_attention_sharded  # noqa: E402
from nos_tpu.ops.ulysses import ulysses_attention_sharded  # noqa: E402
from nos_tpu.parallel.layout import ParallelLayout as JLayout  # noqa: E402
from nos_tpu.parallel.mesh import build_mesh  # noqa: E402
from nos_tpu_torch.ops.attention import xla_attention  # noqa: E402
from nos_tpu_torch.ops.ring_attention import ring_attention  # noqa: E402
from nos_tpu_torch.ops.ulysses import ulysses_attention  # noqa: E402
from nos_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from nos_tpu_torch.parallel.layout import ParallelLayout  # noqa: E402
from nos_tpu_torch.parallel.mesh import init_train_mesh  # noqa: E402

TOL = 2e-4
TIMEOUT_S = 120.0
B, S, D = 2, 32, 16
# (label, query heads, kv heads): kv heads divide by sp 4, as Ulysses
# needs
HEADS = (("mha", 4, 4), ("gqa", 8, 4))
CASES = [(heads, causal) for heads in HEADS for causal in (True, False)]
STRATEGIES = {"ring": ring_attention, "ulysses": ulysses_attention}


def _inputs(h, h_kv, causal):
    rng = np.random.default_rng(h * 10 + h_kv + causal)
    q, do = (rng.standard_normal((B, h, S, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, h_kv, S, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _rank(rank, store, sp, timeout_s):
    """Every case through both strategies on this rank's chunk: (label,
    causal, strategy) -> (out, dq, dk, dv) chunks as numpy."""
    import torch.distributed as dist

    mesh = init_train_mesh(ParallelLayout(sp=sp), rank, ["cpu"] * sp, store,
                           timeout_s)
    try:
        chunk = slice(rank * S // sp, (rank + 1) * S // sp)
        out = {}
        for (label, h, h_kv), causal in CASES:
            arrays = [torch.from_numpy(a[:, :, chunk].copy())
                      for a in _inputs(h, h_kv, causal)]
            for name, fn in STRATEGIES.items():
                q, k, v = (a.clone().requires_grad_() for a in arrays[:3])
                o = fn(q, k, v, mesh, causal=causal)
                o.backward(arrays[3])
                out[label, causal, name] = [t.detach().numpy() for t in (
                    o, q.grad, k.grad, v.grad)]
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"sp{n}")
def ranks(request):
    """(sp, every case's output and gradients joined over the ranks)."""
    sp = request.param
    got = run_ranks(lambda store: _rank(0, store, sp, TIMEOUT_S), _rank,
                    (sp, TIMEOUT_S), sp, TIMEOUT_S)
    joined = {key: [np.concatenate([r[key][i] for r in got], axis=2)
                    for i in range(4)] for key in got[0]}
    return sp, joined


def _full(h, h_kv, causal):
    """Full attention's output and (dq, dk, dv) under autograd: the plain
    unsharded formulation."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(h, h_kv, causal))
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = xla_attention(q, k, v, causal=causal)
    o.backward(do)
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


def _reference(sp, strategy, h, h_kv, causal):
    fn = ring_attention_sharded if strategy == "ring" \
        else ulysses_attention_sharded
    mesh = build_mesh(JLayout(sp=sp), jax.devices()[:sp])
    q, k, v, _ = (jnp.asarray(a) for a in _inputs(h, h_kv, causal))
    return np.asarray(fn(mesh, q, k, v, causal=causal))


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("heads,causal", CASES, ids=[
    f"{h[0]}-{'causal' if c else 'full'}" for h, c in CASES])
def test_matches_reference_and_full_attention(ranks, strategy, heads,
                                              causal):
    """The joined output equals the reference's sharded op and full
    attention (the reference's ``xla_attention``) within 2e-4."""
    sp, joined = ranks
    label, h, h_kv = heads
    got = joined[label, causal, strategy][0]
    want = _reference(sp, strategy, h, h_kv, causal)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    q, k, v, _ = (jnp.asarray(a) for a in _inputs(h, h_kv, causal))
    full = np.asarray(j_xla(q, k, v, causal=causal))
    np.testing.assert_allclose(got, full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("heads,causal", CASES, ids=[
    f"{h[0]}-{'causal' if c else 'full'}" for h, c in CASES])
def test_gradients_match_full_attention(ranks, strategy, heads, causal):
    """dq, dk, dv joined over the ranks (the ring's K/V gradients carried
    back around the ring, Ulysses' through the inverse exchanges) equal
    the unsharded attention's under autograd within 2e-4."""
    _, joined = ranks
    label, h, h_kv = heads
    got = joined[label, causal, strategy]
    want = _full(h, h_kv, causal)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("heads,causal", CASES, ids=[
    f"{h[0]}-{'causal' if c else 'full'}" for h, c in CASES])
def test_ring_and_ulysses_agree(ranks, heads, causal):
    """The reference's ``test_matches_ring_attention``: both strategies
    give the same output and gradients."""
    _, joined = ranks
    for a, b in zip(joined[heads[0], causal, "ring"],
                    joined[heads[0], causal, "ulysses"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_ulysses_refuses_heads_sp_does_not_divide():
    """kv heads 2 over sp 4: the reference's message, raised before any
    exchange."""
    q, k, v = (torch.zeros(1, h, 8, D) for h in (8, 2, 2))
    with pytest.raises(ValueError) as got:
        ulysses_attention(q, k, v, types.SimpleNamespace(sp=4))
    mesh = build_mesh(JLayout(sp=4), jax.devices()[:4])
    with pytest.raises(ValueError) as want:
        ulysses_attention_sharded(mesh, *(jnp.zeros((1, h, 8, D))
                                          for h in (8, 2, 2)))
    assert str(got.value) == str(want.value)
    assert "ulysses needs head counts divisible by the axis size" in \
        str(got.value)
