"""The paged decode kernel's split schedule, emulated on the CPU.

``csrc/paged_decode_attention.cu`` cuts each row's LIVE pages, P_b =
ceil((pos_b + S) / bs) capped at nb, between the ``n_split`` blocks of a
row tile (block i takes pages floor(i P_b / n) .. floor((i + 1) P_b /
n)), each block keeps an f32 online-softmax state (acc, m, l), and the last
block to finish merges them in split order: out = sum_i e^(m_i - M)
acc_i / sum_i e^(m_i - M) l_i, l = 0 -> 1. The emulation below does
that arithmetic in torch and is held at 2e-5 in f32 (the reference's
own pin for its Pallas kernel against its gather oracle) against the
reference kernel in Pallas interpret mode and the port's plain version. The CUDA kernel itself runs
only on the card (chip_smoke.py, phase c).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.ops import attention as ja  # noqa: E402
from nos_tpu_torch.ops import _kernels  # noqa: E402
from nos_tpu_torch.ops import attention as ta  # noqa: E402

ATTN_TOL = 2e-5
NEG = torch.finfo(torch.float32).min


@pytest.fixture
def pallas_compat(monkeypatch):
    """The installed JAX renamed ``pltpu.TPUCompilerParams`` to
    ``CompilerParams``; alias it for the test so the reference kernel
    runs in interpret mode without editing the reference package."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def live_pages(pos: int, s: int, bs: int, nb: int, split: int,
               n_split: int) -> tuple:
    """Block ``split``'s (first page, end page, first token, end token)
    of one row, as the kernel computes them."""
    n_tok = min(pos + s, nb * bs)
    n_pages = -(-n_tok // bs)
    p0 = split * n_pages // n_split
    p1 = (split + 1) * n_pages // n_split
    return p0, p1, p0 * bs, min(p1 * bs, n_tok)


def split_emulation(q, ka, va, table, pos, ks, vs, n_split, scale):
    """[B, H, S, D]: per (batch row, kv head) the n_split blocks' states
    over their live pages, merged in split order."""
    b, h, s, d = q.shape
    h_kv, bs = ka.shape[1], ka.shape[2]
    nb = table.shape[1]
    g = h // h_kv
    out = torch.zeros_like(q)
    for bi in range(b):
        pb = int(pos[bi])
        for hk in range(h_kv):
            rows = q[bi, hk * g:(hk + 1) * g].reshape(g * s, d)
            lim = pb + torch.arange(g * s) % s      # last visible slot
            states = []
            for split in range(n_split):
                _, _, t0, t1 = live_pages(pb, s, bs, nb, split, n_split)
                if t1 <= t0:                        # no live page here
                    states.append((torch.zeros(g * s, d),
                                   torch.full((g * s,), NEG),
                                   torch.zeros(g * s)))
                    continue
                tok = torch.arange(t0, t1)
                phys = table[bi, tok // bs].long()
                k, v = ka[phys, hk, tok % bs], va[phys, hk, tok % bs]
                if ks is not None:
                    k = ta.dequantize_kv(k, ks[phys, hk, tok % bs], q.dtype)
                    v = ta.dequantize_kv(v, vs[phys, hk, tok % bs], q.dtype)
                seen = tok[None, :] <= lim[:, None]
                sc = torch.where(seen, rows @ k.float().T * scale,
                                 torch.tensor(NEG))
                m = sc.max(-1).values
                p = torch.where(seen, torch.exp(sc - m[:, None]),
                                torch.tensor(0.0))
                states.append((p @ v.float(), m, p.sum(-1)))
            big = torch.stack([m for _, m, _ in states]).max(0).values
            acc = torch.zeros(g * s, d)
            den = torch.zeros(g * s)
            for a, m, l_ in states:                  # split order
                w = torch.exp(m - big)
                acc = acc + w[:, None] * a
                den = den + w * l_
            den = torch.where(den == 0, torch.ones_like(den), den)
            out[bi, hk * g:(hk + 1) * g] = (acc / den[:, None]).reshape(
                g, s, d).to(q.dtype)
    return out


def _case(s, int8, seed=3):
    """Row 0 inactive (all-null table, pos 0); row 1's window starts on a
    page boundary; row 2 has one live page (P_b < n_split); row 3 runs
    to the table's end; shuffled physical blocks, null tails."""
    rng = np.random.default_rng(seed + 10 * s + int8)
    b, h_kv, g, d, bs, nb = 4, 2, 2, 16, 8, 6
    nb_phys = b * nb + 1
    q = rng.normal(size=(b, h_kv * g, s, d)).astype(np.float32)
    ka = rng.normal(size=(nb_phys, h_kv, bs, d)).astype(np.float32)
    va = rng.normal(size=(nb_phys, h_kv, bs, d)).astype(np.float32)
    pos = np.array([0, 2 * bs, 3, nb * bs - s], np.int32)
    table = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, nb_phys))
    i = 0
    for row in range(1, b):
        n = (int(pos[row]) + s - 1) // bs + 1
        table[row, :n] = perm[i:i + n]
        i += n
    ks = vs = None
    if int8:
        ka, ks = (np.asarray(x) for x in ja.quantize_kv(jnp.asarray(ka)))
        va, vs = (np.asarray(x) for x in ja.quantize_kv(jnp.asarray(va)))
    return q, ka, va, table, pos, ks, vs


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_split", [1, 2, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s", [1, 4])
def test_split_schedule_matches_reference(s, int8, n_split, pallas_compat):
    q, ka, va, table, pos, ks, vs = _case(s, int8)
    d = q.shape[-1]
    bs, nb = ka.shape[2], table.shape[1]
    # the case covers what the schedule must get right
    assert any(live_pages(int(p), s, bs, nb, 0, 1)[1] < n_split
               for p in pos) or n_split == 1
    J = jnp.asarray
    jk = dict(k_scale=J(ks), v_scale=J(vs)) if int8 else {}
    kernel = np.asarray(ja.paged_decode_attention(
        J(q), J(ka), J(va), J(table), J(pos), interpret=True, **jk))
    tk = dict(k_scale=_t(ks), v_scale=_t(vs)) if int8 else {}
    plain = ta.paged_decode_attention_reference(
        _t(q), _t(ka), _t(va), _t(table), _t(pos), **tk).numpy()
    got = split_emulation(_t(q), _t(ka), _t(va), _t(table), _t(pos),
                          _t(ks), _t(vs), n_split, d ** -0.5).numpy()
    assert np.isfinite(got).all()
    for ref in (kernel, plain):
        assert np.max(np.abs(got - ref)) <= ATTN_TOL


@pytest.mark.parametrize("pos,s,n_split", [(0, 1, 8), (16, 1, 2),
                                           (3, 4, 8), (47, 1, 8),
                                           (40, 4, 2)])
def test_live_pages_cover_each_live_token_once(pos, s, n_split):
    bs, nb = 8, 6
    ranges = [live_pages(pos, s, bs, nb, i, n_split) for i in range(n_split)]
    tokens = [t for _, _, t0, t1 in ranges for t in range(t0, t1)]
    assert tokens == list(range(min(pos + s, nb * bs)))
    # every block's pages are live: none past the row's last live page
    assert all(p1 <= -(-min(pos + s, nb * bs) // bs) for _, p1, _, _ in ranges)


@pytest.mark.parametrize("tiles,sms,want", [
    (64, 132, 8),      # the decode slice: B 8 x Hkv 8, one row tile
    (128, 132, 4),     # S 4: two row tiles of 8 rows
    (133, 132, 2),
    (264, 132, 1),     # exactly two blocks per SM already
    (8192, 132, 1),    # a prefill window fills the card alone
    (1, 132, 8),       # capped at MAX_SPLIT
    (1, 1, 2),
])
def test_paged_splits_choice(tiles, sms, want):
    assert _kernels.paged_splits(tiles, sms) == want


@pytest.mark.parametrize("gs,tiles", [(1, 1), (4, 1), (5, 1), (8, 1),
                                      (16, 2), (1024, 128)])
def test_paged_row_tiles(gs, tiles):
    assert _kernels.paged_row_tiles(gs) == tiles


def test_scratch_is_kept_per_stream_and_reused():
    """The split merge's scratch and tickets belong to one (device,
    stream): two streams get two buffers (their launches never share
    tickets), a second call on a stream with the same or smaller sizes
    allocates nothing, and a larger call grows only that stream's."""
    paged = _kernels._PagedDecode()
    cpu = torch.device("cpu")
    a = paged._part(cpu, 1, 64, 8)
    b = paged._part(cpu, 2, 64, 8)
    assert a[0].data_ptr() != b[0].data_ptr()
    assert a[1].data_ptr() != b[1].data_ptr()
    again = paged._part(cpu, 1, 32, 4)
    assert again[0] is a[0] and again[1] is a[1]
    grown = paged._part(cpu, 1, 128, 8)
    assert grown[0].numel() == 128 and grown[0] is not a[0]
    assert paged._part(cpu, 2, 64, 8)[0] is b[0]
    assert not grown[1].any() and grown[1].dtype == torch.int32
    assert sorted(paged._scratch) == [(cpu, 1), (cpu, 2)]
