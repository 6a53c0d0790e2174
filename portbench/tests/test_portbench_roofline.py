"""The frozen formulas against the bounds PERF.md's kernel table gives
at its shapes (4 significant digits, ms)."""
from __future__ import annotations

from portbench import roofline
from portbench.model import Dims, param_count


def ms(flops, nbytes):
    return roofline.least_s(flops, nbytes) * 1e3


def sig4(x):
    return float(f"{x:.4g}")


def test_paged_decode_bound():
    # B 8, H 32/8, D 128, block 16, 3,810 live tokens (phase c's decode)
    live = [476] * 6 + [477, 477]
    assert sum(live) == 3810
    f, b = roofline.paged_decode_work(live, h=32, h_kv=8, d=128, bs=16)
    assert b / roofline.HBM_BYTES_PER_S > f / roofline.BF16_FLOPS
    assert sig4(ms(f, b)) == 0.004698


def test_flash_bounds():
    w = roofline.flash_work(8, 16, 4, 2048, 128)
    assert sig4(ms(*w["fwd"])) == 0.1390
    assert sig4(ms(*w["bwd_dkdv"])) == 0.2781
    assert sig4(ms(*w["bwd_dq"])) == 0.2086
    assert sig4(ms(*w["bwd_preprocess"])) == 0.04038


def test_adamw_bound():
    # phase (g)'s 1.1 B model: 12 bf16 leaves, norms among them
    dm = Dims(vocab=32000, d_model=2048, n_layers=16, n_heads=16,
              n_kv_heads=4, d_ff=8192, max_seq=2048, rope_theta=1e4,
              norm_eps=1e-6)
    n = param_count(dm) + dm.n_layers * 2 * dm.d_model + dm.d_model
    assert sig4(roofline.adamw_bytes(n) / roofline.HBM_BYTES_PER_S
                * 1e3) == 4.615


def test_step_counts_at_the_cells():
    mistral = Dims(vocab=32000, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq=4096, rope_theta=1e4,
                   norm_eps=1e-6)
    # 7.24 B parameters; 14.2 GB of weights read a decode tick (the
    # embedding, a lookup of a few rows, left out)
    assert round(param_count(mistral) / 1e9, 2) == 7.24
    assert round(roofline.weight_bytes(mistral, 0) / 1e9, 1) == 14.2
    mixtral = Dims(vocab=32000, d_model=4096, n_layers=16, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq=4096, rope_theta=1e6,
                   norm_eps=1e-6, n_experts=8, top_k=2)
    # at 64 rows every expert is read: 45.1 GB of experts, 46.7 GB in all
    assert roofline.experts_touched(mixtral, 64) > 7.999
    assert round(roofline.weight_bytes(mixtral, 8) / 1e9, 1) == 46.7
    # a token's products: 2 x its active parameters, the embedding left
    # out (attention 2 x 4 d^2 x 5/8, two experts' 3 d f, the router)
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 14336 \
        + 4096 * 8
    assert roofline.token_flops(mixtral) == 2 * (16 * per_layer
                                                 + 4096 * 32000)
