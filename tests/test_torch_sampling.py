"""Port parity: sampled decoding (``models/generate.py``'s truncation and
``generate``, ``models/serving.py``'s per-slot sampling, the
``cmd/generate.py`` binary) against the JAX reference on the CPU, tiny
f32 configs, the reference's params carried over by ``params_from_jax``.

Bounds:
- truncation masks equal the reference's on every row but those whose
  cumulative nucleus probability lies within 1e-6 of ``top_p`` (the two
  frameworks sum the softmax in another order); those are counted and
  must stay under 10% of each grid: at a 64-token vocab none occur, at
  32000 the tail tokens where a 0.9 or 0.99 nucleus ends hold ~1e-5 each,
  so a 2e-6 window catches a few rows in a hundred (3 of 64 here);
- sampled streams equal the reference's token for token; in a grid of
  seeds at most one stream may diverge, and only at a first divergence
  whose top two perturbed logits (JAX's) lie within 1e-4 of each other,
  where the last-ulp differences of the logits and of the gumbel noise
  (tests/test_torch_prng.py) can swap them;
- greedy rows stay token-equal, as before.
"""
import dataclasses
import json
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.cmd import generate as jcli  # noqa: E402
from nos_tpu.models import generate as jg  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd import generate as tcli  # noqa: E402
from nos_tpu_torch.models import generate as tg  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.utils import prng  # noqa: E402

KW = dict(vocab=64, d_model=16, n_layers=2, n_heads=2, n_kv_heads=1,
          d_ff=32, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
ENGINE = dict(kv_block_size=8, kv_blocks=40)
NEAR_P = 1e-6
GAP = 1e-4
NEG = float(np.finfo(np.float32).min)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture
def ref_gather(monkeypatch):
    """The reference engine's gather formulation, its designated oracle
    (the port's engines take ``paged_impl`` instead)."""
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")


def _engine(tp, max_batch=4, **kw):
    return DecodeServer(tp, TCFG, max_batch=max_batch, device="cpu",
                        paged_impl="kernel", **dict(ENGINE, **kw))


# ---------------------------------------------------------------- truncation
def _near_p_rows(logits: np.ndarray, top_k: np.ndarray,
                 top_p: np.ndarray) -> np.ndarray:
    """Rows whose nucleus boundary is a near tie: some cumulative
    probability of the top-k-masked sorted row within NEAR_P of top_p."""
    v = logits.shape[1]
    k_eff = np.where((top_k > 0) & (top_k < v), top_k, v)
    srt = -np.sort(-logits.astype(np.float64), axis=1)
    srt = np.where(np.arange(v)[None] < k_eff[:, None], srt, -np.inf)
    e = np.exp(srt - srt[:, :1])
    cum = np.cumsum(e / e.sum(1, keepdims=True), axis=1)
    on = (top_p > 0) & (top_p < 1)
    return on & (np.abs(cum - top_p[:, None]) < NEAR_P).any(axis=1)


@pytest.mark.parametrize("rows,vocab,scale,seed", [
    (512, 64, 2.0, 0), (512, 64, 0.5, 1), (64, 32000, 3.0, 2),
    (256, 13, 1.0, 3)])
def test_truncate_logits_rows_masks_equal_reference(rows, vocab, scale,
                                                    seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(rows, vocab)) * scale).astype(np.float32)
    top_k = rng.choice([0, 1, 3, 10, vocab - 1, vocab, vocab + 5],
                       size=rows).astype(np.int32)
    top_p = rng.choice([0.0, 0.2, 0.5, 0.9, 0.99, 1.0, 1e-3],
                       size=rows).astype(np.float32)
    want = np.asarray(jg._truncate_logits_rows(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = tg._truncate_logits_rows(torch.from_numpy(logits),
                                   torch.from_numpy(top_k).long(),
                                   torch.from_numpy(top_p)).numpy()
    near = _near_p_rows(logits, top_k, top_p)
    assert near.mean() < 0.1, near.sum()
    np.testing.assert_array_equal(got[~near] > NEG, want[~near] > NEG)
    # kept logits pass through untouched
    keep = want > NEG
    np.testing.assert_array_equal(got[keep & ~near[:, None]],
                                  want[keep & ~near[:, None]])


def test_truncate_off_rows_pass_through():
    logits = torch.randn(4, 9, generator=torch.Generator().manual_seed(0))
    out = tg._truncate_logits_rows(logits, torch.tensor([0, 9, 20, 0]),
                                   torch.tensor([0.0, 1.0, 0.0, 1.5]))
    assert torch.equal(out, logits)
    assert tg._truncate_logits(logits, 0, 0.0) is logits


def test_top_k_restricts_sampled_tokens(params):
    logits = torch.tensor([[1.0, 5.0, 3.0, 4.0, 2.0]])
    t = tg._truncate_logits(logits, top_k=2, top_p=0.0)
    assert (t[0] > NEG).tolist() == [False, True, False, True, False]
    # top_k=1 at any temperature IS greedy
    _, tp = params
    prompt = [[0, 0]] * 4
    out = tg.generate(tp, TCFG, prompt, 8, temperature=1.5, top_k=1,
                      rng=prng.PRNGKey(3), device="cpu")
    greedy = tg.generate(tp, TCFG, prompt, 8, device="cpu")
    assert torch.equal(out, greedy)


def test_top_p_nucleus_keeps_smallest_covering_set():
    logits = torch.log(torch.tensor([[0.643, 0.236, 0.087, 0.032, 0.002]]))
    t = tg._truncate_logits(logits, top_k=0, top_p=0.8)
    # 0.643 < 0.8, 0.643 + 0.236 crosses it -> nucleus = first two
    assert (t[0] > NEG).tolist() == [True, True, False, False, False]
    assert torch.equal(tg._truncate_logits(logits, 0, 1.0), logits)


def test_top_k_then_top_p_sequential_semantics():
    # after top_k=3 the renormalized probs are ~[0.666, 0.244, 0.090];
    # nucleus 0.8 keeps the first two of the survivors
    logits = torch.log(torch.tensor([[0.643, 0.236, 0.087, 0.032, 0.002]]))
    t = tg._truncate_logits(logits, top_k=3, top_p=0.8)
    assert (t[0] > NEG).tolist() == [True, True, False, False, False]


# ------------------------------------------------------------------ generate
def _tempered_truncated(jp, prefix, kw) -> np.ndarray:
    """JAX's tempered, truncated logits after ``prefix`` (teacher-forced):
    what the reference sampled the next token from."""
    logits = jtfm.forward(jp, JCFG, jnp.asarray([prefix], jnp.int32))[0, -1]
    return np.asarray(jg._truncate_logits(logits / kw["temperature"],
                                          kw.get("top_k", 0),
                                          kw.get("top_p", 0.0)))


GEN_GRID = [dict(temperature=0.8), dict(temperature=1.2, top_k=5),
            dict(temperature=0.7, top_p=0.9),
            dict(temperature=1.0, top_k=10, top_p=0.8)]


@pytest.mark.parametrize("kw", GEN_GRID, ids=["t", "t_k", "t_p", "t_k_p"])
def test_generate_sampled_equals_reference(params, kw):
    """Ten seeds x a ragged batch of three rows x 12 tokens, the same
    ``rng`` on both sides (``split(rng, 12)[i]`` keys step i)."""
    jp, tp = params
    diverged = []
    for seed in range(10):
        prompt = np.random.default_rng(seed).integers(0, 64, size=(3, 5))
        want = np.asarray(jg.generate(jp, JCFG, jnp.asarray(prompt,
                                                            jnp.int32), 12,
                                      rng=jax.random.PRNGKey(seed), **kw))
        got = tg.generate(tp, TCFG, prompt.tolist(), 12,
                          rng=prng.PRNGKey(seed), device="cpu", **kw).numpy()
        for row in np.nonzero((want != got).any(axis=1))[0]:
            step = int(np.argmax(want[row] != got[row])) - 5
            keys = jax.random.split(jax.random.PRNGKey(seed), 12)
            # the batch's noise at that step, this row's slice of it
            noise = np.asarray(jax.random.gumbel(keys[step], (3, 64)))[row]
            t = _tempered_truncated(jp, want[row][:5 + step], kw)
            top2 = np.sort(t + noise)[-2:]
            diverged.append((seed, int(row), step, float(top2[1] - top2[0])))
    assert len(diverged) <= 1, diverged
    assert all(gap < GAP for *_, gap in diverged), diverged


def test_temperature_sampling_reproducible_and_guarded(params):
    _, tp = params
    prompt = [[0, 0]]
    a = tg.generate(tp, TCFG, prompt, 5, temperature=0.8,
                    rng=prng.PRNGKey(7), device="cpu")
    b = tg.generate(tp, TCFG, prompt, 5, temperature=0.8,
                    rng=prng.PRNGKey(7), device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rng"):
        tg.generate(tp, TCFG, prompt, 3, temperature=0.5, device="cpu")


@pytest.mark.parametrize("kw,with_rng", [
    (dict(top_p=0.9), False), (dict(top_k=3), False),
    (dict(temperature=0.8, top_p=90.0), True),
    (dict(temperature=0.8, top_k=-2), True),
    (dict(temperature=0.5), False)])
def test_generate_refusals_carry_reference_messages(params, kw, with_rng):
    jp, tp = params
    jkw = dict(kw, rng=jax.random.PRNGKey(0)) if with_rng else kw
    tkw = dict(kw, rng=prng.PRNGKey(0)) if with_rng else kw
    with pytest.raises(ValueError) as ref:
        jg.generate(jp, JCFG, jnp.zeros((1, 2), jnp.int32), 3, **jkw)
    with pytest.raises(ValueError) as port:
        tg.generate(tp, TCFG, [[0, 0]], 3, device="cpu", **tkw)
    assert str(port.value) == str(ref.value)


def test_generate_refuses_a_mesh(params):
    _, tp = params
    with pytest.raises(ValueError, match="mesh"):
        tg.generate(tp, TCFG, [[1, 2]], 2, mesh=object(), device="cpu")


# ------------------------------------------------------------------- engine
ARRIVALS = [
    ([1, 2, 3], 6, 0, dict(temperature=0.8, seed=3)),
    ([60, 61], 9, 2, dict()),
    ([7, 7, 7, 7, 7], 5, 1, dict(temperature=1.3, top_k=5, seed=9)),
    ([4, 5], 10, 0, dict(temperature=0.6, top_p=0.9)),
    ([11, 12, 13, 14, 15, 16, 17, 18, 19], 7, 3,
     dict(temperature=1.0, top_k=8, top_p=0.7, seed=2 ** 32 - 1)),
    ([9], 12, 0, dict(temperature=2.0)),
]


def _serve(engine):
    rids = []
    for prompt, n, steps, kw in ARRIVALS:
        rids.append(engine.submit(prompt, n, **kw))
        for _ in range(steps):
            engine.step()
    out = engine.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_sampled_tokens_equal_reference_engine(params, ref_gather,
                                                      kv_dtype):
    """Staggered arrivals, more requests than slots, mixed greedy and
    sampled requests with per-request temperature, top-k, top-p and
    seeds (one defaulting to its request id)."""
    jp, tp = params
    ref = _serve(JDecodeServer(jp, JCFG, max_batch=2, kv_dtype=kv_dtype,
                               **ENGINE))
    got = _serve(_engine(tp, max_batch=2, kv_dtype=kv_dtype))
    assert got == ref


@pytest.mark.parametrize("kw", [
    dict(top_k=2), dict(top_p=0.5), dict(temperature=0.5, top_k=-1),
    dict(temperature=0.5, top_p=1.5)])
def test_submit_refusals_carry_reference_messages(params, ref_gather, kw):
    jp, tp = params
    with pytest.raises(ValueError) as ref:
        JDecodeServer(jp, JCFG, max_batch=2, **ENGINE).submit([1, 2], 3,
                                                              **kw)
    with pytest.raises(ValueError) as port:
        _engine(tp, max_batch=2).submit([1, 2], 3, **kw)
    assert str(port.value) == str(ref.value)


def _alone(tp, prompt, n, **sampling):
    srv = _engine(tp)
    rid = srv.submit(prompt, n, **sampling)
    return srv.drain()[rid]


def test_sampled_request_invariant_to_batch_composition(params):
    """The same (prompt, seed, params) alone and wedged into a busy mixed
    batch (greedy and sampled neighbours, other lengths, staggered
    admission) gives the same tokens."""
    _, tp = params
    req = dict(temperature=0.8, top_k=6, seed=42)
    alone = _alone(tp, [1, 7, 3], 10, **req)
    srv = _engine(tp)
    srv.submit([2, 2], 6)
    srv.submit([5, 1, 1, 8], 12, temperature=1.2, seed=7)
    srv.submit([9], 3, temperature=0.5, top_p=0.9, seed=1)
    rid = srv.submit([1, 7, 3], 10, **req)
    for _ in range(4):
        srv.step()
    srv.submit([4, 4, 4], 5)
    srv.submit([8, 3], 4, temperature=0.9, seed=99)
    assert srv.drain()[rid] == alone


def test_greedy_rows_stay_bit_exact_in_mixed_batch(params):
    """A greedy request sharing ticks with sampled neighbours equals
    ``generate`` exactly."""
    _, tp = params
    prompt = [3, 1, 4, 1]
    want = tg.generate(tp, TCFG, [prompt], 8, device="cpu")[0].tolist()
    srv = _engine(tp, max_batch=3)
    srv.submit([2, 7], 9, temperature=1.0, seed=5)
    rid = srv.submit(prompt, 8)
    srv.submit([6], 7, temperature=0.6, top_k=3, seed=11)
    assert srv.drain()[rid] == want


def test_seed_determinism_and_divergence(params):
    _, tp = params
    a = _alone(tp, [1, 2, 3], 8, temperature=1.0, seed=123)
    b = _alone(tp, [1, 2, 3], 8, temperature=1.0, seed=123)
    c = _alone(tp, [1, 2, 3], 8, temperature=1.0, seed=124)
    assert a == b
    assert a != c  # astronomically unlikely to collide over 8 tokens


def test_sampled_tokens_stay_in_truncated_support(params):
    """top-k slots only emit tokens in the top k given their own prefix
    (teacher-forced), at the prefill position and every decode one."""
    _, tp = params
    prompt = [1, 7, 3]
    out = _alone(tp, prompt, 8, temperature=0.9, top_k=3, seed=2)
    cache = tg.init_cache(TCFG, 1, TCFG.max_seq, device="cpu")
    logits, _ = tg.forward_with_cache(tp, TCFG, torch.tensor([out]), cache)
    for pos in range(len(prompt) - 1, len(out) - 1):
        allowed = tg._truncate_logits(logits[0, pos] / 0.9, 3, 0.0)
        assert float(allowed[out[pos + 1]]) > NEG, (pos, out[pos + 1])


def test_greedy_tick_runs_no_sampling_ops(params, monkeypatch):
    """A tick in which no active slot samples never reaches the sampling
    path; a tick with one sampled slot does, once."""
    _, tp = params
    calls = []
    srv = _engine(tp)
    real = srv._sample
    monkeypatch.setattr(srv, "_sample",
                        lambda *a: calls.append(1) or real(*a))
    srv.submit([1, 2], 4)
    srv.submit([3], 4)
    srv.drain()
    assert calls == []
    srv.submit([1, 2], 3, temperature=0.7)
    srv.submit([3], 3)
    srv.drain()
    assert len(calls) == 2          # two decode ticks after the prefill


# -------------------------------------------------------------------- binary
def test_generate_config_has_every_reference_field_and_default():
    want = {f.name: f.default for f in dataclasses.fields(jcli.GenerateConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tcli.GenerateConfig)}
    assert got == want


def test_generate_from_yaml_file_matches_reference(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "gen.yaml"
    path.write_text("d_model: 64\nmax_new_tokens: 5\ntemperature: 0.7\n"
                    "top_k: 4\nbf16: false\n")
    assert (dataclasses.asdict(tcli.GenerateConfig.from_yaml_file(str(path)))
            == dataclasses.asdict(jcli.GenerateConfig.from_yaml_file(
                str(path))))
    path.write_text("d_model: 64\nwidth: 3\n")
    with pytest.raises(ValueError, match="unknown generate config keys"):
        tcli.GenerateConfig.from_yaml_file(str(path))


def _quiet_logging(monkeypatch) -> list:
    """Both binaries' ``setup_logging`` recorded instead of replacing the
    test runner's root handlers."""
    import nos_tpu.cmd
    import nos_tpu_torch.cmd

    calls = []
    for mod in (nos_tpu.cmd, nos_tpu_torch.cmd):
        monkeypatch.setattr(mod, "setup_logging",
                            lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("flags", [
    [], ["--temperature", "0.8"],
    ["--temperature", "1.1", "--top-k", "7", "--top-p", "0.9"]],
    ids=["greedy", "sampled", "truncated"])
def test_main_prints_the_reference_lines(params, monkeypatch, capsys,
                                         flags):
    """``main`` on ragged prompts (two length groups, each with its own
    ``fold_in(rng, group)``), with both binaries' weights the bridged
    reference params: the same JSON lines, and the same logging set-up."""
    jp, tp = params
    calls = _quiet_logging(monkeypatch)
    monkeypatch.setattr(jcli, "load_params", lambda cfg: (JCFG, jp))
    monkeypatch.setattr(tcli, "load_params",
                        lambda cfg, device=None: (TCFG, tp))
    argv = ["--prompt", "1,2,3", "--prompt", "9", "--prompt", "4,5,6",
            "--max-new-tokens", "6", "--log-format", "json", *flags]
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv, device="cpu")
    got = capsys.readouterr().out
    assert got == want
    assert calls[0] == calls[1] == ((0, "json"), {"numeric_level": 20})
    assert len(got.splitlines()) == 3
    assert all(len(json.loads(line)["tokens"]) in (7, 9)
               for line in got.splitlines())


def test_run_refuses_empty_prompts_and_main_bad_tokens(capsys,
                                                       monkeypatch):
    _quiet_logging(monkeypatch)
    with pytest.raises(ValueError, match="empty prompt"):
        tcli.run(tcli.GenerateConfig(), [[1], []], device="cpu")
    with pytest.raises(SystemExit):
        tcli.main(["--prompt", "1,x"], device="cpu")
    assert "non-integer token" in capsys.readouterr().err


def test_json_log_lines_equal_the_reference_outside_a_span():
    from nos_tpu.cmd import JsonLogFormatter as JFormatter
    from nos_tpu_torch.cmd import JsonLogFormatter

    record = logging.LogRecord("nos_tpu_torch.generate", logging.INFO,
                               __file__, 1, "quantized %s", ("w",), None)
    assert JsonLogFormatter().format(record) == JFormatter().format(record)
