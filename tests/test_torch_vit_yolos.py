"""Port parity: ``nos_tpu_torch.models.vit`` / ``models.yolos`` (and the
three layer helpers they use) against ``nos_tpu.models.vit`` /
``models.yolos`` on the CPU, on the reference's params carried over by
``params_from_jax``; and the sharing client's one-shot line.

At these widths the reference's attention runs XLA's path (26 and 17
tokens, not multiples of 128); the port's runs the flash kernels' plain
version through the registered flash op. Tolerances: the layer helpers,
boxes and GIoU 1e-6; forwards 1e-5 in f32 and 2e-2 in bf16 of the
output's largest magnitude (at least 1: XLA:CPU rounds a fused
elementwise chain to bf16 once where PyTorch rounds each op, a bf16 ulp
or two on logits near 3); the criterion's losses 1e-5 relative and its
gradients within 1e-5 of each tensor's largest element (at least 1).
Matching and top-k indices must be EQUAL to JAX's, ties included
(stable sorts, first-index argmax, the plan's subnormals flushed).
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import vit as jv  # noqa: E402
from nos_tpu.models import yolos as jy  # noqa: E402
from nos_tpu.ops import layers as jl  # noqa: E402
from nos_tpu_torch.cmd import sharing_client  # noqa: E402
from nos_tpu_torch.models import vit as tv  # noqa: E402
from nos_tpu_torch.models import yolos as ty  # noqa: E402
from nos_tpu_torch.ops import layers as tl  # noqa: E402

TINY = dict(image_size=32, patch=8, d_model=64, n_layers=2, n_heads=4,
            d_ff=128)
N_DET = 10
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _leaves(tree, prefix=""):
    """(name, leaf) pairs of a nested dict, sorted by name."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (_leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                else [(prefix + k, v)])
    return out


@pytest.mark.parametrize("name", ["layer_norm", "gelu_mlp", "patchify"])
def test_layer_helpers_match(name):
    rng = np.random.default_rng(0)
    if name == "layer_norm":
        x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3 + 1
        s = rng.normal(size=16).astype(np.float32)
        b = rng.normal(size=16).astype(np.float32)
        want = jl.layer_norm(x, s, b)
        got = tl.layer_norm(_t(x), _t(s), _t(b))
    elif name == "gelu_mlp":
        x = rng.normal(size=(3, 5, 16)).astype(np.float32)
        w_in = rng.normal(size=(16, 32)).astype(np.float32) * 0.25
        b_in = rng.normal(size=32).astype(np.float32)
        w_out = rng.normal(size=(32, 16)).astype(np.float32) * 0.2
        b_out = rng.normal(size=16).astype(np.float32)
        want = jl.gelu_mlp(x, w_in, b_in, w_out, b_out)
        got = tl.gelu_mlp(*(_t(a) for a in (x, w_in, b_in, w_out, b_out)))
    else:
        x = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
        want = jl.patchify(x, 8)
        got = tl.patchify(_t(x), 8)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def _images(b=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("model", ["vit", "yolos"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_forward_matches_reference(model, dt):
    jdt, tdt, tol = DTYPES[dt]
    images = _images()
    if model == "vit":
        jcfg = jv.ViTConfig(n_classes=12, dtype=jdt, **TINY)
        tcfg = tv.ViTConfig(n_classes=12, dtype=tdt, **TINY)
        jparams = jv.init_params(jax.random.PRNGKey(0), jcfg)
        want = [jv.forward(jparams, jcfg, images)]
        got = [tv.forward(tv.params_from_jax(jparams, "cpu"), tcfg,
                          _t(images))]
    else:
        jcfg = jy.YolosConfig(n_det_tokens=N_DET, n_classes=7, dtype=jdt,
                              **TINY)
        tcfg = ty.YolosConfig(n_det_tokens=N_DET, n_classes=7, dtype=tdt,
                              **TINY)
        jparams = jy.init_params(jax.random.PRNGKey(0), jcfg)
        want = jy.forward(jparams, jcfg, images)
        got = ty.forward(tv.params_from_jax(jparams, "cpu"), tcfg,
                         _t(images))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(model, _np(g), w, tol)


def _boxes(rng, *shape):
    """Random cxcywh boxes inside the unit square, w and h in [0.05,
    0.5)."""
    c = rng.uniform(0.25, 0.75, size=shape + (2,))
    wh = rng.uniform(0.05, 0.5, size=shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["cxcywh_to_xyxy", "generalized_box_iou"])
def test_box_math_matches(fn):
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 2, 6), _boxes(rng, 2, 4)
    if fn == "cxcywh_to_xyxy":
        want, got = jy.cxcywh_to_xyxy(a), ty.cxcywh_to_xyxy(_t(a))
    else:
        # a degenerate (zero-area) box and a disjoint pair among them
        a[0, 0, 2:] = 0.0
        b[0, 0] = [0.05, 0.05, 0.02, 0.02]
        xa, xb = jy.cxcywh_to_xyxy(a), jy.cxcywh_to_xyxy(b)
        want = jy.generalized_box_iou(xa, xb)
        got = ty.generalized_box_iou(_t(xa), _t(xb))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def _match_case(kind):
    rng = np.random.default_rng({"random": 3, "ties": 4, "padded": 5,
                                 "all_padded": 6}[kind])
    b, q, t = 3, 8, 5
    cost = rng.normal(size=(b, q, t)).astype(np.float32)
    mask = np.ones((b, t), bool)
    if kind == "ties":
        # equal rows and columns, and whole rows of one value: the plan
        # ties exactly, and argmax / the target order must break the
        # ties as JAX does (here two targets split a query's mass and
        # the next picks fall among subnormal entries XLA flushes)
        cost[:, 1] = cost[:, 0]
        cost[:, :, 3] = cost[:, :, 1]
        cost[1] = 0.5
        cost[2, :, :2] = 0.25
    elif kind == "padded":
        mask[:, 3:] = False
        mask[1, 1] = False
    elif kind == "all_padded":
        mask[:] = False
    return cost, mask


@pytest.mark.parametrize("kind", ["random", "ties", "padded", "all_padded"])
def test_sinkhorn_match_equals_reference(kind):
    cost, mask = _match_case(kind)
    want = np.asarray(jax.vmap(jy.sinkhorn_match)(cost, mask))
    got = ty.sinkhorn_match(_t(cost), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    # one-to-one over the live targets
    for row, live in zip(got.numpy(), mask):
        assert len(set(row[live])) == live.sum()


def test_argmax_takes_the_first_of_ties_and_of_all_neg_inf():
    """The greedy pass's and postprocess's argmax: the first of equal
    values, index 0 for a column of all -inf, as ``jnp.argmax``."""
    inf = np.float32(np.inf)
    cols = np.array([[0.5, 2.0, 2.0, 1.0], [-inf, -inf, -inf, -inf],
                     [-inf, 3.0, -inf, 3.0], [0.0, 0.0, 0.0, 0.0]],
                    np.float32)
    want = np.asarray(jnp.argmax(cols, axis=1))
    got = torch.argmax(_t(cols), dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [1, 0, 1, 0]


def _criterion_inputs(seed=7, b=2, q=N_DET, c=7, t=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, q, c + 1)).astype(np.float32)
    boxes = _boxes(rng, b, q)
    labels = rng.integers(0, c, size=(b, t)).astype(np.int32)
    labels[1, 2:] = -1                      # padded targets
    return logits, boxes, labels, _boxes(rng, b, t)


def _close(name, got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("wrt", ["params", "boxes"])
def test_set_criterion_losses_and_grads(wrt):
    logits, boxes, labels, t_boxes = _criterion_inputs()
    if wrt == "boxes":
        def jloss(lg, bx):
            out = jy.set_criterion(lg, bx, labels, t_boxes)
            return out["total"], out
        (total, jout), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(logits, boxes)
        inputs = [_t(logits).requires_grad_(), _t(boxes).requires_grad_()]
        tout = ty.set_criterion(*inputs, _t(labels), _t(t_boxes))
        names = ["logits", "boxes"]
    else:
        jcfg = jy.YolosConfig(n_det_tokens=N_DET, n_classes=7,
                              dtype=jnp.float32, **TINY)
        tcfg = ty.YolosConfig(n_det_tokens=N_DET, n_classes=7,
                              dtype=torch.float32, **TINY)
        jparams = jy.init_params(jax.random.PRNGKey(0), jcfg)
        images = _images(b=2)

        def jloss(p):
            lg, bx = jy.forward(p, jcfg, images)
            out = jy.set_criterion(lg, bx, labels, t_boxes)
            return out["total"], out
        (total, jout), jgrad_tree = jax.value_and_grad(
            jloss, has_aux=True)(jparams)
        jleaves = _leaves(jgrad_tree)
        names = [n for n, _ in jleaves]
        jgrads = [g for _, g in jleaves]
        tparams = tv.params_from_jax(jparams, "cpu")
        inputs = [leaf.requires_grad_() for _, leaf in _leaves(tparams)]
        tout = ty.set_criterion(*ty.forward(tparams, tcfg, _t(images)),
                                _t(labels), _t(t_boxes))
    for key in ("class", "l1", "giou", "total"):
        np.testing.assert_allclose(float(tout[key].detach()),
                                   float(jout[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    grads = torch.autograd.grad(tout["total"], inputs)
    for name, g, w in zip(names, grads, jgrads):
        _close(name, _np(g), w, 1e-5)


def test_set_criterion_refuses_more_targets_than_queries():
    logits, boxes, _, _ = _criterion_inputs(q=3)
    with pytest.raises(ValueError, match=r"^5 targets exceed 3 detection "
                       r"tokens: one-to-one matching needs T <= Q \(raise "
                       r"n_det_tokens or truncate the target set\)$"):
        ty.set_criterion(_t(logits), _t(boxes),
                         torch.zeros((2, 5), dtype=torch.long),
                         torch.zeros((2, 5, 4)))


def test_postprocess_ties_give_reference_indices():
    # equal scores across queries and equal class probabilities within
    # one: the stable sort and the first-index argmax decide
    logits = np.zeros((2, 6, 5), np.float32)
    logits[0, :, 1] = [2.0, 2.0, 1.0, 2.0, 0.0, 1.0]
    logits[0, 2, 3] = 1.0
    logits[1, :, :] = np.random.default_rng(8).normal(size=(6, 5))
    logits[1, 4] = logits[1, 1]
    boxes = _boxes(np.random.default_rng(9), 2, 6)
    want = jy.postprocess(logits, boxes, top_k=4)
    got = ty.postprocess(_t(logits), _t(boxes), top_k=4)
    for key in ("labels", "scores", "boxes"):
        if key == "labels":
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        else:
            np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                       rtol=0, atol=1e-6)
    # the boxes follow the indices: equal boxes mean equal picks
    np.testing.assert_array_equal(
        _np(got["boxes"]), np.asarray(want["boxes"]))


@pytest.mark.parametrize("model", ["vit", "yolos"])
def test_param_count_matches_reference(model):
    """The published widths, built on the meta device (nothing
    allocated) against the reference's shapes (``eval_shape``)."""
    if model == "vit":
        jparams = jax.eval_shape(lambda: jv.init_params(
            jax.random.PRNGKey(0), jv.ViTConfig()))
        got = tv.param_count(tv.init_params(None, tv.ViTConfig(), "meta"))
    else:
        jparams = jax.eval_shape(lambda: jy.init_params(
            jax.random.PRNGKey(0), jy.YolosConfig()))
        got = ty.param_count(ty.init_params(None, ty.YolosConfig(), "meta"))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert got == want


@pytest.mark.parametrize("mode", ["multiplex", "timeslice", "subslice"])
def test_sharing_client_oneshot_line(mode, capsys):
    cfg = ty.YolosConfig(n_det_tokens=4, n_classes=3, dtype=torch.float32,
                         **dict(TINY, n_layers=1))
    sharing_client.main(["--mode", mode, "--streams", "3", "--seconds",
                         "0.01", "--oneshot", "--device", "cpu"], cfg=cfg)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == ["avg_inference_s", "mode", "streams"]
    assert line["mode"] == mode and line["streams"] == 3
    assert line["avg_inference_s"] > 0
