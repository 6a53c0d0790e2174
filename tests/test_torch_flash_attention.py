"""Port parity: ``attention`` (the training path's flash attention) on
the CPU against the JAX reference.

On CPU tensors the port runs the kernels' plain versions
(``flash_attention_reference`` / ``flash_attention_backward_reference``)
behind the same ``torch.autograd.Function`` the card runs its CUDA
kernels through. The reference runs ``xla_attention`` here (its splash
gate needs a TPU), and its TPU splash kernel runs in Pallas interpret
mode, built as ``_splash_kernel_cached`` builds it. Tolerances, on
unit-normal inputs: f32 1e-4 absolute (the two JAX paths differ by
2.2e-6 forward and 2.4e-5 in the gradients at these shapes); bf16 a few
bf16 ulps of the outputs' scale, since the plain backward keeps f32
where JAX's autodiff rounds to bf16 between its ops. The CUDA kernels
run only on the card (chip_smoke.py holds them against these plain
versions).
"""
import ctypes
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.ops import attention as ja  # noqa: E402
from nos_tpu_torch.ops import _kernels  # noqa: E402
from nos_tpu_torch.ops import attention as ta  # noqa: E402

F32_TOL = 1e-4
# bf16: forward one output ulp at |o| < 4 (2^-6) plus rounding of the
# probabilities; gradients 4 ulps of their largest element
BF16_FWD_TOL = 2.0 ** -5
BF16_GRAD_REL = 2.0 ** -6

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, h, h_kv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, h_kv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, h_kv, s, d)).astype(np.float32)
    do = rng.normal(size=(b, h, s, d)).astype(np.float32)
    return q, k, v, do


def _jax_fwd_grads(fn, arrays, jdt):
    q, k, v, do = (jnp.asarray(a, jdt) for a in arrays)
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *vjp(do))]


def _port_fwd_grads(arrays, tdt, causal):
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_()
    out = ta.attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return [t.detach().float().numpy() for t in (out, *grads)]


def _assert_close(got, want, dtype, what):
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        if dtype == "f32":
            np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=0,
                                       err_msg=f"{what} {name}")
        else:
            tol = (BF16_FWD_TOL if name == "o"
                   else BF16_GRAD_REL * np.abs(w).max())
            np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference_xla_forward_and_grads(causal, g, dtype):
    arrays = _inputs(g, 2, 4, 4 // g, 48, 32)
    want = _jax_fwd_grads(
        lambda q, k, v: ja.xla_attention(q, k, v, causal=causal), arrays,
        DTYPES[dtype][1])
    got = _port_fwd_grads(arrays, DTYPES[dtype][2], causal)
    _assert_close(got, want, dtype, f"causal={causal} g={g}")


@pytest.fixture
def splash_interpret():
    """The reference's splash kernel in Pallas interpret mode, built with
    ``_splash_kernel_cached``'s block sizes and mask, applied as
    ``_splash_attention`` applies it (q pre-scaled in its dtype, vmap
    over batch)."""
    sk, mk = ja._splash_mod()

    def attend(q, k, v, *, causal):
        h, s, d = q.shape[1], q.shape[2], q.shape[3]
        bq, bkv = ja._clamp_block(512, s), ja._clamp_block(512, s)
        bd = ja._clamp_block(128, s)
        bs = sk.BlockSizes(
            block_q=bq, block_kv=bkv, block_kv_compute=bkv, block_q_dkv=bd,
            block_kv_dkv=bd, block_kv_dkv_compute=bd, block_q_dq=None,
            block_kv_dq=None, use_fused_bwd_kernel=True)
        mask_cls = mk.CausalMask if causal else mk.FullMask
        mask = mk.MultiHeadMask([mask_cls((s, s)) for _ in range(h)])
        kernel = sk.make_splash_mha(mask=mask, block_sizes=bs,
                                    head_shards=1, q_seq_shards=1,
                                    interpret=True)
        return jax.vmap(kernel)((q * d ** -0.5).astype(q.dtype), k, v)

    return attend


@pytest.mark.parametrize("causal,g", [(True, 2), (False, 4)])
def test_attention_matches_reference_splash_kernel_interpret(
        splash_interpret, causal, g):
    arrays = _inputs(10 + g, 1, 4, 4 // g, 256, 128)
    want = _jax_fwd_grads(
        lambda q, k, v: splash_interpret(q, k, v, causal=causal), arrays,
        jnp.float32)
    got = _port_fwd_grads(arrays, torch.float32, causal)
    _assert_close(got, want, "f32", f"splash causal={causal} g={g}")


@pytest.mark.parametrize("causal", [True, False])
def test_backward_reference_matches_autograd_through_xla_attention(causal):
    """The textbook backward (D = rowsum(dO*O), dS = P*(dP - D)) against
    jax.vjp of the reference's xla_attention, GQA g = 2, ragged S."""
    q, k, v, do = _inputs(3, 2, 4, 2, 37, 16)
    want = _jax_fwd_grads(
        lambda q, k, v: ja.xla_attention(q, k, v, causal=causal),
        (q, k, v, do), jnp.float32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ta.flash_attention_reference(tq, tk, tv, causal=causal,
                                          scale=16 ** -0.5)
    grads = ta.flash_attention_backward_reference(
        tq, tk, tv, o, lse, tdo, causal=causal, scale=16 ** -0.5)
    np.testing.assert_allclose(o.numpy(), want[0], atol=1e-5, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=name)


def _blocked_bf16_forward(q, k, v, *, causal, scale, tile=128):
    """The bf16 Hopper forward's arithmetic (csrc/flash_attention.cu,
    flash_fwd_wgmma_kernel) in f32 on the CPU: 128-key tiles, f32 scores
    multiplied by scale * log2(e), their running max (log2 units), masked
    pairs at probability 0, unnormalised probabilities summed into l in
    f32 and rounded to bf16 before P.V, which accumulates in f32, the
    alpha rescale of l and O per tile, then O / l rounded to bf16 once and
    lse = (m + log2 l) ln 2."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, h_kv, h // h_kv, s_q, d)
    kf, vf = k.float().unsqueeze(2), v.float().unsqueeze(2)
    scale2 = scale * float(np.log2(np.e))
    neg = torch.finfo(torch.float32).min
    m = torch.full((b, h_kv, h // h_kv, s_q, 1), neg)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    last_key = torch.arange(s_q)[:, None] + (s_k - s_q)
    for k0 in range(0, s_k, tile):
        kt, vt = kf[..., k0:k0 + tile, :], vf[..., k0:k0 + tile, :]
        s = torch.matmul(qg, kt.transpose(-1, -2)) * scale2
        keys = torch.arange(k0, k0 + kt.shape[-2])[None, :]
        ok = keys <= last_key if causal else torch.ones_like(s, dtype=bool)
        m_new = torch.maximum(
            m, torch.where(ok, s, neg).amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(), vt)
        m = m_new
    o = (acc / l).to(torch.bfloat16).reshape(b, h, s_q, d)
    lse = ((m + torch.log2(l)) * float(np.log(2.0))).reshape(b, h, s_q)
    return o, lse


# chip_smoke.py's bf16 O pin, |d| <= r |ref| + m P.|V|: each side rounds
# O once (r = 2 x 2^-8, bf16's unit roundoff) and its probabilities once
# (m = 2 x 2^-8: the reference its normalised P, the kernel its
# unnormalised P, which the f32 rescale by alpha keeps relative); and the
# LSE pin, |d| <= 2^-16 (1 + |ref|)
O_RN_PIN = (2.0 ** -7, 2.0 ** -7)
LSE_PIN = 2.0 ** -16


# sign -1: the running max is taken on the scaled scores, so a negative
# scale (the largest raw score is then the least likely key) holds too
@pytest.mark.parametrize("causal,g,s_q,s_k,sign", [
    (True, 1, 256, 256, 1), (True, 4, 256, 256, 1), (False, 1, 256, 256, 1),
    (False, 4, 256, 256, 1), (True, 4, 200, 200, 1), (True, 4, 72, 200, 1),
    (True, 4, 200, 200, -1), (False, 4, 200, 200, -1)])
def test_blocked_bf16_forward_holds_to_the_o_pin(causal, g, s_q, s_k, sign):
    """The new forward's blocked numerics against JAX's xla_attention and
    the port's plain version, per element, D 64, bf16 inputs."""
    rng = np.random.default_rng(20 + g + s_q + sign)
    b, h, d = 2, 4, 64
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((b, h, s_q, d), (b, h // g, s_k, d), (b, h // g, s_k, d))]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    scale = sign * d ** -0.5
    o, lse = _blocked_bf16_forward(q, k, v, causal=causal, scale=scale)
    o_plain, lse_plain = ta.flash_attention_reference(
        q, k, v, causal=causal, scale=scale)
    o_jax = np.asarray(ja.xla_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), causal=causal,
        scale=scale), np.float32)
    mag = ta.flash_attention_reference(
        q.float(), k.float(), v.float().abs(), causal=causal,
        scale=scale)[0].numpy()
    r, m = O_RN_PIN
    for name, want in (("plain", o_plain.float().numpy()), ("jax", o_jax)):
        share = np.abs(o.float().numpy() - want) / (r * np.abs(want)
                                                    + m * mag)
        assert share.max() <= 1.0, (name, float(share.max()))
    lse_share = (np.abs(lse.numpy() - lse_plain.numpy())
                 / (LSE_PIN * (1 + np.abs(lse_plain.numpy()))))
    assert lse_share.max() <= 1.0, float(lse_share.max())


def test_lse_is_the_logsumexp_of_the_masked_scores():
    q, k, v, _ = _inputs(4, 1, 2, 1, 20, 8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = ta.flash_attention_reference(tq, tk, tv, causal=True,
                                          scale=0.5)
    scores = np.einsum("hqd,kd->hqk", q[0], k[0, 0]) * 0.5
    scores = np.where(np.tri(20, dtype=bool), scores, -np.inf)
    want = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) \
        + scores.max(-1)
    np.testing.assert_allclose(lse[0].numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture
def spy(monkeypatch):
    """Counts calls of the plain versions the Function routes to."""
    calls = {"fwd": 0, "bwd": 0}

    def wrap(name, key):
        orig = getattr(ta, name)

        def counted(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(ta, name, counted)

    wrap("flash_attention_reference", "fwd")
    wrap("flash_attention_backward_reference", "bwd")
    return calls


@pytest.mark.parametrize("impl", ["splash", "flash"])
def test_function_routes_cpu_tensors_to_the_plain_versions(
        spy, monkeypatch, impl):
    monkeypatch.setenv("NOS_TPU_TORCH_ATTN_IMPL", impl)
    for k in _kernels.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(5, 1, 4, 2, 16, 8))
    out = ta.attention(q, k, v, causal=True)
    assert spy == {"fwd": 1, "bwd": 0}
    out.backward(do.detach())
    assert spy == {"fwd": 1, "bwd": 1}
    assert all(k.launches == 0 for k in _kernels.KERNELS)
    assert q.grad is not None and k.grad.shape == k.shape


def test_xla_impl_runs_autograd_through_xla_attention(spy, monkeypatch):
    monkeypatch.setenv("NOS_TPU_TORCH_ATTN_IMPL", "xla")
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(6, 1, 2, 2, 8, 8))
    ta.attention(q, k, v, causal=True).backward(do.detach())
    assert spy == {"fwd": 0, "bwd": 0}
    assert ta.effective_impl(q.shape, k.shape) == "xla"
    monkeypatch.setenv("NOS_TPU_TORCH_ATTN_IMPL", "splash")
    assert ta.effective_impl(q.shape, k.shape, force_xla=True) == "xla"


def test_effective_impl_default_and_unknown(monkeypatch):
    monkeypatch.delenv("NOS_TPU_TORCH_ATTN_IMPL", raising=False)
    # no shape routes to the plain path: ragged S and any head_dim
    assert ta.effective_impl((1, 2, 100, 48), (1, 1, 100, 48)) == "splash"
    monkeypatch.setenv("NOS_TPU_TORCH_ATTN_IMPL", "pallas")
    with pytest.raises(ValueError, match="NOS_TPU_TORCH_ATTN_IMPL"):
        ta.effective_impl((1, 2, 8, 8), (1, 1, 8, 8))


def test_head_dim_gate_raises_on_the_card_only():
    cuda = torch.device("cuda")
    for d in _kernels.HEAD_DIMS:
        ta.check_attention_head_dim(d, cuda, "splash")
    with pytest.raises(ValueError, match="head_dim 96"):
        ta.check_attention_head_dim(96, cuda, "flash")
    ta.check_attention_head_dim(96, cuda, "xla")
    ta.check_attention_head_dim(96, torch.device("cpu"), "splash")


def test_flash_kernels_share_one_source_and_count_launches():
    flash = [_kernels.flash_fwd, _kernels.flash_bwd_pre,
             _kernels.flash_bwd_dkdv, _kernels.flash_bwd_dq]
    assert all(k in _kernels.KERNELS for k in flash)
    assert {k.source.name for k in flash} == {"flash_attention.cu"}
    assert len({k.symbol for k in flash}) == 4
    assert (_kernels.CSRC / "flash_attention.cu").exists()


def _c_entries():
    """{symbol: [(is_pointer, base type)]} of every ``extern "C" int
    nos_*`` entry in ``csrc/*.cu``, parsed from the source."""
    out = {}
    for src in sorted(_kernels.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (nos_\w+)\(([^)]*)\)',
                                       src.read_text()):
            out[name] = [("*" in p, p.replace("*", " ").split()[-2])
                         for p in params.split(",")]
    return out


def test_every_c_entry_has_a_wrapper():
    assert set(_c_entries()) == {k.symbol for k in _kernels.KERNELS}


@pytest.mark.parametrize("kernel", _kernels.KERNELS, ids=lambda k: k.symbol)
def test_wrapper_argtypes_match_the_c_entry(kernel):
    """A stale ``argtypes`` entry makes ctypes pass a pointer as a 32-bit
    int (or a float as an int) on the card; only the source shows it."""
    params = _c_entries()[kernel.symbol]
    assert len(kernel.argtypes) == len(params), kernel.symbol
    scalar = {"int": ctypes.c_int, "float": ctypes.c_float}
    for i, ((pointer, base), got) in enumerate(zip(params, kernel.argtypes)):
        want = ctypes.c_void_p if pointer else scalar[base]
        assert got is want, (kernel.symbol, i, base, got)


def test_library_name_hashes_the_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    (tmp_path / "a.cuh").write_text("// v1\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda.h>\n#include "a.cuh"\n')
    assert _kernels._includes(src) == [tmp_path / "a.cuh"]
    before = _kernels._lib_path(src)
    (tmp_path / "a.cuh").write_text("// v2\n")
    assert _kernels._lib_path(src) != before
    assert _kernels._lib_path(src).name.startswith("k-")
