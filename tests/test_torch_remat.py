"""Port parity: the named remat policies (``remat_policy`` "full",
"dots", "except_mlp", "minimal") of ``nos_tpu_torch`` against
``nos_tpu`` on the CPU, f32, at ``tests/test_remat_policies.py``'s
``BASE`` widths, dense and with 4 experts.

Every policy is the same math; only what a layer keeps for backward
differs. For each policy, from the reference's params
(``params_from_jax``) and one batch:

- loss within 1e-5 absolute and every gradient leaf within 1e-4 of the
  leaf's largest |gradient| of the reference's ``jax.value_and_grad``
  under the same policy;
- the gradients bit-equal to the port's under "full";
- the flash forward's plain version runs 2 x L times a step under
  "full" and "dots" (the forward and the recompute) and L times under
  "except_mlp" and "minimal" (its outputs are saved);
- the products the recompute runs (counted in the backward, less those
  of a run without remat) are ``remat_rerun_flops``'.

What a layer keeps is measured as the bytes of the tensors made in the
forward that are still alive when it ends (the autograd graph's and the
checkpoints' own): a checkpoint's hooks take precedence over an outer
``saved_tensors_hooks``, and the selective checkpoint keeps its saved
outputs in a store of its own, so only the live set sees both. It is
ordered as the reference's compiled temp memory is
(``test_named_policies_save_less_than_dots``).
"""
import gc
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.ops import attention as tatt  # noqa: E402

BASE = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64)
MODELS = {"dense": {}, "moe": {"n_experts": 4}}
POLICIES = ["full", "dots", "except_mlp", "minimal"]
BATCH, SEQ = 2, 64
LOSS_ABS, GRAD_TOL = 1e-5, 1e-4


def _batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, BASE["vocab"], size=(BATCH, SEQ)).astype(
        np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _configs(model, policy, **kw):
    widths = dict(BASE, **MODELS[model], **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, remat_policy=policy,
                                 **widths),
            tt.TransformerConfig(dtype=torch.float32, remat_policy=policy,
                                 **widths))


class _Products(TorchDispatchMode):
    """FLOPs of the products dispatched while active (``mm``, ``bmm``
    and the ``qkv_proj`` op, whose products the mode does not see), and
    the flash op's calls."""

    def __init__(self, cfg, tokens: int):
        super().__init__()
        self.cfg, self.tokens = cfg, tokens
        self.flops, self.flash = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.mm.default:
            (m, k), n = args[0].shape, args[1].shape[1]
            self.flops += 2 * m * k * n
        elif func is torch.ops.aten.bmm.default:
            (b, m, k), n = args[0].shape, args[1].shape[2]
            self.flops += 2 * b * m * k * n
        elif func is torch.ops.nos_tpu_torch.qkv_proj.default:
            c = self.cfg
            self.flops += 2 * self.tokens * c.d_model * (c.d_model
                                                         + 2 * c.kv_dim)
        elif func is torch.ops.nos_tpu_torch.flash_attention_fwd.default:
            self.flash += 1
        return out


def _port_step(tcfg, jparams, batch, monkeypatch):
    """loss, gradient leaves, calls of the flash forward's plain version,
    and the products counted in the backward."""
    params = tt.params_from_jax(jparams, device="cpu")
    leaves = tt.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    calls = []
    real = tatt.flash_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tatt, "flash_attention_reference", counted)
    loss = tt.loss_fn(params, tcfg, {k: torch.from_numpy(v).long()
                                     for k, v in batch.items()})
    count = _Products(tcfg, BATCH * SEQ)
    with count:
        grads = torch.autograd.grad(loss, leaves)
    monkeypatch.setattr(tatt, "flash_attention_reference", real)
    return float(loss.detach()), grads, len(calls), count


@pytest.fixture(scope="module")
def runs():
    """{model: (reference params, the port's "full" gradients, the
    products a backward without remat runs)}, made once."""
    out = {}
    batch = _batch()
    mp = pytest.MonkeyPatch()
    try:
        for model in MODELS:
            jcfg, tcfg = _configs(model, "full")
            jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
            _, full, _, _ = _port_step(tcfg, jparams, batch, mp)
            _, nocfg = _configs(model, "full", remat=False)
            _, _, _, plain = _port_step(nocfg, jparams, batch, mp)
            out[model] = (jparams, full, plain.flops)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_reference_and_full(policy, model, runs,
                                           monkeypatch):
    jparams, full, plain_flops = runs[model]
    batch = _batch()
    jcfg, tcfg = _configs(model, policy)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, jcfg, b)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads, calls, count = _port_step(tcfg, jparams, batch,
                                           monkeypatch)

    assert abs(loss - float(jloss)) <= LOSS_ABS
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        scale = np.abs(jg).max()
        assert np.abs(g.numpy() - jg).max() <= GRAD_TOL * scale
    assert all(torch.equal(a, b) for a, b in zip(grads, full))

    L = BASE["n_layers"]
    per_layer = 2 if policy in ("full", "dots") else 1
    assert calls == L * per_layer
    assert count.flash == L * (per_layer - 1)
    rerun = tt.remat_rerun_flops(tcfg, BATCH, SEQ)
    assert count.flops - plain_flops == rerun["products"]
    assert rerun["attention_layers"] == count.flash


class _Live(TorchDispatchMode):
    """Every tensor storage an op makes while active, with the op that
    made it first; ``alive()`` is what is still held."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen = self.made.get(st.data_ptr())
                # a freed storage's address is reused: the new one counts
                if seen is None or seen[0]() is None:
                    self.made[st.data_ptr()] = (weakref.ref(st),
                                                st.nbytes(), func)
        return out

    def alive(self, exclude) -> dict:
        gc.collect()
        return {ptr: (n, func) for ptr, (ref, n, func) in self.made.items()
                if ref() is not None and ptr not in exclude}


def _held_after_forward(policy, model, **widths):
    """(bytes, {op: count}) of the storages the forward made and still
    holds when it ends, the params excluded."""
    cfg = tt.TransformerConfig(**dict(BASE, **MODELS[model], **widths),
                               remat_policy=policy, dtype=torch.float32)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = tt.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, cfg.max_seq), generator=gen)
    live = _Live()
    with live:
        loss = tt.loss_fn(params, cfg, {"tokens": tokens,
                                        "targets": tokens})
    held = live.alive({p.untyped_storage().data_ptr() for p in leaves})
    ops = {}
    for _, func in held.values():
        ops[func] = ops.get(func, 0) + 1
    loss.backward()
    return sum(n for n, _ in held.values()), ops


@pytest.mark.parametrize("model", list(MODELS))
def test_saved_bytes_are_ordered_as_the_reference(model):
    """At ``test_named_policies_save_less_than_dots``' shape (d_ff
    intermediates dominate): minimal <= except_mlp <= dots, and full <=
    except_mlp."""
    sizes = {p: _held_after_forward(p, model, d_model=128, d_ff=512,
                                    n_layers=4, max_seq=256)[0]
             for p in POLICIES}
    assert sizes["minimal"] <= sizes["except_mlp"] <= sizes["dots"]
    assert sizes["full"] <= sizes["except_mlp"]
    assert sizes["full"] < sizes["minimal"]


def test_dots_saves_products_with_no_batch_dims_only():
    """Under "dots" the MoE's dispatch, expert and combine products
    (``bmm``: their expert and batch axes are batch dimensions) are not
    kept, nor is the flash op's output; the products with no batch
    dimension are, a layer's o and router products (``mm``) and its
    q/k/v op; of the dense FFN's, gate and up, not down. Under
    "minimal" only the flash op's outputs are kept."""
    L = BASE["n_layers"]
    _, ops = _held_after_forward("dots", "moe")
    flash = torch.ops.nos_tpu_torch.flash_attention_fwd.default
    qkv = torch.ops.nos_tpu_torch.qkv_proj.default
    assert torch.ops.aten.bmm.default not in ops
    assert flash not in ops
    assert ops[qkv] == 3 * L                     # q, k, v a layer
    assert ops[torch.ops.aten.mm.default] == 2 * L     # o and router
    # the dense FFN's products have no batch dimension: kept, but for
    # the down product, whose output no backward reads (the reference's
    # partial evaluation drops it): the reference's set, o, gate and up
    _, ops = _held_after_forward("dots", "dense")
    assert ops[torch.ops.aten.mm.default] == 3 * L     # o, gate, up
    _, ops = _held_after_forward("minimal", "moe")
    assert ops[flash] == 2 * L                   # o and lse a layer
    assert qkv not in ops and torch.ops.aten.bmm.default not in ops


def test_saved_ops_name_the_reference_tags():
    flash = torch.ops.nos_tpu_torch.flash_attention_fwd.default
    qkv = torch.ops.nos_tpu_torch.qkv_proj.default
    assert tt.remat_saved_ops("full") == frozenset()
    assert tt.remat_saved_ops("minimal") == {flash}
    assert tt.remat_saved_ops("except_mlp") == {flash, qkv}
    assert tt.remat_saved_ops("dots") == {torch.ops.aten.mm.default, qkv}


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="remat_policy"):
        tt.TransformerConfig(**BASE, remat_policy="everything")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_proj_is_the_unfused_block_bit_for_bit(dtype):
    """The q/k/v op's outputs and gradients equal autograd's through the
    three products and ``apply_rope`` run apart, bit for bit: the op
    changes what a checkpoint can save, not the numbers (so "full"
    trains as it did before the op)."""
    from nos_tpu_torch.ops import layers

    gen = torch.Generator().manual_seed(0)
    b, s, d, h, h_kv, hd = 2, 16, 64, 4, 2, 16
    x = torch.randn(b, s, d, generator=gen).to(dtype)
    ws = [(torch.randn(d, n, generator=gen) * d ** -0.5).to(dtype)
          for n in (h * hd, h_kv * hd, h_kv * hd)]
    freqs = layers.rope_frequencies(hd, 32)
    grads_out = [torch.randn(b, s, n, hd, generator=gen).to(dtype)
                 for n in (h, h_kv, h_kv)]

    def run(fused):
        leaves = [t.clone().requires_grad_() for t in [x] + ws]
        hx, wq, wk, wv = leaves
        if fused:
            outs = layers.qkv_proj(hx, wq, wk, wv,
                                   *layers.rope_rows(freqs, None, s),
                                   h, h_kv)
        else:
            outs = (layers.apply_rope(
                        torch.matmul(hx, wq).reshape(b, s, h, hd), freqs),
                    layers.apply_rope(
                        torch.matmul(hx, wk).reshape(b, s, h_kv, hd), freqs),
                    torch.matmul(hx, wv).reshape(b, s, h_kv, hd))
        return list(outs) + list(torch.autograd.grad(outs, leaves,
                                                     grads_out))

    assert all(torch.equal(a, c) for a, c in zip(run(True), run(False)))
