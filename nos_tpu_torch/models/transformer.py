"""Decoder-only transformer (port of ``nos_tpu/models/transformer.py``
without a mesh): config, params, the training forward, the loss and the
train step.

Params are a plain dict of tensors with the reference's layout: stacked
``layers`` with a leading L axis, ``embed [vocab, d]``, ``unembed
[d, vocab]``, f32 norms. PyTorch runs eagerly, so the reference's
``lax.scan`` over layers is a Python loop over the stacked tensors, and
its ``jax.checkpoint(policy=...)`` per layer is ``torch.utils.checkpoint``
with a selective-checkpoint ``context_fn`` per ``remat_policy``
(``remat_context_fn``): "full" saves nothing, "dots" the products with
no batch dimension, "except_mlp" and "minimal" the outputs of the ops
that stand for the reference's names (``REMAT_NAMES``). With
``n_experts > 0`` every layer's FFN is the reference's top-2 MoE
(``w_router`` [L, d, E] f32, experts [L, E, d, f] / [L, E, f, d]); the
decode path serves it (``models/generate.py``) and the training
``forward`` trains it, the layers' aux losses averaged into
``loss_fn``.

With a ``parallel.mesh.TrainMesh`` (``forward``/``loss_fn``/
``make_train_step``'s ``mesh``) params are this rank's parts
(``rank_params``, in ``param_shardings``' layout: ``TP_SPLIT``,
``FSDP_SPLIT`` and ``EP_SPLIT``) and the batch its data rows' sequence
chunk: under tp a layer runs its H/tp query heads, Hkv/tp kv heads and
d_ff/tp (each expert's, under MoE), the embedding is a vocab-split
lookup and the loss Megatron's vocab-parallel cross-entropy; under fsdp
each layer gathers its leaves just before use (inside the remat
checkpoint, so a recompute gathers again); under ep a rank holds E/ep
experts and the tokens of every ep rank of its data index; under sp
attention is the ring's or Ulysses' (``cfg.sp_strategy``) and rope
takes global positions. Every leaf's gradient is averaged over the
ranks holding distinct tokens (dp x fsdp x sp). Pipeline parallelism is
not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn,
)

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.ops.attention import attention
from nos_tpu_torch.ops.layers import (
    qkv_proj, rms_norm, rope_frequencies, rope_rows, swiglu,
)
from nos_tpu_torch.ops.moe import expert_capacity, moe_ffn, moe_ffn_mesh
from nos_tpu_torch.ops.ring_attention import ring_attention, ring_attention_out
from nos_tpu_torch.ops.ulysses import check_ulysses_heads, ulysses_attention
from nos_tpu_torch.ops.quant import QuantLinear
from nos_tpu_torch.parallel.mesh import TrainMesh

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # per-layer rematerialization: what backward recomputes of a layer.
    # "full" recomputes all of it; "dots" saves the products with no
    # batch dimension; "except_mlp" saves q/k/v and the attention op's
    # outputs; "minimal" the attention op's outputs only
    # (``remat_context_fn``)
    remat: bool = True
    remat_policy: str = "full"
    # > 0: the lm head + cross-entropy run in sequence chunks of this size
    # under checkpoint, so the f32 [B, S, vocab] logits never exist at once
    loss_chunk: int = 0
    # grouped-query attention: 0 means MHA (n_kv_heads == n_heads)
    n_kv_heads: int = 0
    sp_strategy: str = "ring"
    n_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide by n_kv_heads")
        if self.sp_strategy not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_strategy {self.sp_strategy!r}")
        if self.remat_policy not in ("full", "dots", "except_mlp", "minimal"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random params with the reference's shapes and init scales
    (normal * fan_in**-0.5, norms at 1; with ``n_experts`` an f32 router
    and stacked experts). The numbers differ from JAX's PRNG stream;
    tests that compare the two bridge the reference's params with
    ``params_from_jax``. Each layer is drawn in f32 and cast into the
    stacked tensor one at a time, so the f32 transient is one layer's
    leaf, not the model's."""
    device = resolve_device(device)
    d, L = cfg.d_model, cfg.n_layers

    def randn(shape, fan_in, dtype=cfg.dtype):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * fan_in ** -0.5
                ).to(dtype)

    shapes = _layer_shapes(cfg)
    layers = {k: torch.empty((L,) + shp, dtype=dt, device=device)
              for k, (shp, _, dt) in shapes.items()}
    for i in range(L):
        for k, (shp, fan_in, dt) in shapes.items():
            layers[k][i] = randn(shp, fan_in, dt)
    layers["attn_norm"] = torch.ones((L, d), dtype=torch.float32,
                                     device=device)
    layers["mlp_norm"] = torch.ones((L, d), dtype=torch.float32,
                                    device=device)
    return {
        "embed": randn((cfg.vocab, d), d),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "unembed": randn((d, cfg.vocab), d),
    }


def _layer_shapes(cfg: TransformerConfig) -> dict:
    """name -> (one layer's shape, fan_in, dtype) of the drawn leaves."""
    d, h, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"wq": ((d, d), d, cfg.dtype),
              "wk": ((d, cfg.kv_dim), d, cfg.dtype),
              "wv": ((d, cfg.kv_dim), d, cfg.dtype),
              "wo": ((d, d), d, cfg.dtype)}
    if e > 0:
        shapes.update(w_router=((d, e), d, torch.float32),
                      w_gate=((e, d, h), d, cfg.dtype),
                      w_up=((e, d, h), d, cfg.dtype),
                      w_down=((e, h, d), h, cfg.dtype))
    else:
        shapes.update(w_gate=((d, h), d, cfg.dtype),
                      w_up=((d, h), d, cfg.dtype),
                      w_down=((h, d), h, cfg.dtype))
    return shapes


def abstract_params(cfg: TransformerConfig) -> Params:
    """``init_params``' tree as tensors on the meta device (shapes and
    dtypes, no storage): the port's ``jax.eval_shape`` of the init, the
    template a checkpoint restore fills leaf by leaf."""
    meta = torch.device("meta")
    L, d = cfg.n_layers, cfg.d_model
    layers = {k: torch.empty((L,) + shp, dtype=dt, device=meta)
              for k, (shp, _, dt) in _layer_shapes(cfg).items()}
    for k in ("attn_norm", "mlp_norm"):
        layers[k] = torch.empty((L, d), dtype=torch.float32, device=meta)
    return {
        "embed": torch.empty((cfg.vocab, d), dtype=cfg.dtype, device=meta),
        "layers": layers,
        "final_norm": torch.empty((d,), dtype=torch.float32, device=meta),
        "unembed": torch.empty((d, cfg.vocab), dtype=cfg.dtype,
                               device=meta),
    }


def _tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                 # a writable host copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: carry the raw 16 bits, bit-exact
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """The weights bridge: the reference's params pytree (dicts of numpy
    or JAX arrays, with ``QuantLinear`` leaves from
    ``nos_tpu.models.quant.quantize_params``) -> the port's, bit-equal.
    A QuantLinear is recognised by its ``q``/``scale`` attributes, so the
    port needs no import of the reference package."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantLinear(q=_tensor_from_numpy(tree.q, device),
                           scale=_tensor_from_numpy(tree.scale, device))
    return _tensor_from_numpy(tree, device)


# ``nos_tpu/models/transformer.py::param_shardings``' Megatron layout over
# tp: the matrix axis each leaf splits along (None: replicated). q, k, v,
# gate and up split their output features (whole heads: shard r holds q
# heads [r H/tp, (r+1) H/tp) and kv heads [r Hkv/tp, (r+1) Hkv/tp), so
# the GQA grouping stays within a shard); o and down their input
# features; the embedding its vocab rows, the unembedding its vocab
# columns. The MoE family's expert stacks ([L, E, d, f], [L, E, f, d])
# split each expert's d_ff through the same negative axes and the router
# is replicated: the reference's ``ns(None, "ep", "fsdp", "tp")``, in
# serving (no ep axis) and in training (the E axis over ep: EP_SPLIT)
TP_SPLIT = {"embed": 0, "unembed": -1, "final_norm": None,
            "attn_norm": None, "mlp_norm": None, "wq": -1, "wk": -1,
            "wv": -1, "w_gate": -1, "w_up": -1, "wo": -2, "w_down": -2,
            "w_router": None}
# ... and the axis each splits along over fsdp (the matmul axis tp does
# not take: d_model everywhere, the experts' and the router's too);
# the embeddings and norms are whole on every fsdp rank
FSDP_SPLIT = {"embed": None, "unembed": None, "final_norm": None,
              "attn_norm": None, "mlp_norm": None, "wq": -2, "wk": -2,
              "wv": -2, "w_gate": -2, "w_up": -2, "wo": -1, "w_down": -1,
              "w_router": -2}
# ... and over ep (the MoE family only): the expert stacks' E axis
# (``ns(None, "ep", ...)``); every other leaf, the router included, is
# whole on every ep rank
EP_SPLIT = {"w_gate": -3, "w_up": -3, "w_down": -3}


@dataclass
class TpParams:
    """Params split over a ``TpMesh`` (``shard_params``): ``shards[r]``
    is shard r's params dict, on its device, with the reference's keys
    and the split axes cut to 1/tp."""
    mesh: Any
    shards: List[Params]


def check_tp(cfg: TransformerConfig, tp: int) -> None:
    """Raise a ValueError when ``cfg`` cannot be served over ``tp``
    shards: the reference's messages for the head axis."""
    if cfg.kv_heads % tp:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} not divisible by tp={tp}; the "
            f"cache head axis cannot shard evenly")
    for name, n in (("d_ff", cfg.d_ff), ("vocab", cfg.vocab)):
        if n % tp:
            raise ValueError(f"{name} {n} not divisible by tp={tp}")


def _split_leaf(leaf, axis: Optional[int], mesh) -> list:
    if axis is None:
        return mesh.broadcast(leaf)
    if isinstance(leaf, QuantLinear):
        # scales are per output channel: they split with column and
        # vocab-row splits and are whole under a row-parallel split
        scale_axis = {-1: -1, 0: 0}.get(axis)
        scales = (mesh.broadcast(leaf.scale) if scale_axis is None
                  else mesh.split(leaf.scale, scale_axis))
        return [QuantLinear(q=q, scale=sc)
                for q, sc in zip(mesh.split(leaf.q, axis), scales)]
    return mesh.split(leaf, axis)


def _gather_leaf(parts: list, axis: Optional[int], mesh):
    if axis is None:
        return parts[0].to(mesh.devices[0])
    if isinstance(parts[0], QuantLinear):
        scale_axis = {-1: -1, 0: 0}.get(axis)
        scale = (parts[0].scale.to(mesh.devices[0]) if scale_axis is None
                 else mesh.gather([p.scale for p in parts], scale_axis))
        return QuantLinear(q=mesh.gather([p.q for p in parts], axis),
                           scale=scale)
    return mesh.gather(parts, axis)


def shard_params(params: Params, cfg: TransformerConfig, mesh) -> TpParams:
    """Split ``params`` (plain or ``quantize_params``' int8 twin) over
    ``mesh`` in ``TP_SPLIT``'s layout, each shard on its device; the
    reference's ``device_put(params, param_shardings(mesh, cfg))``
    (``quant_param_shardings`` for the int8 twin, whose experts and
    router stay unquantized)."""
    check_tp(cfg, mesh.tp)
    shards: List[Params] = [{"layers": {}} for _ in range(mesh.tp)]
    for name, leaf in params.items():
        if name == "layers":
            for lname, lleaf in leaf.items():
                for sh, part in zip(shards, _split_leaf(
                        lleaf, TP_SPLIT[lname], mesh)):
                    sh["layers"][lname] = part
        else:
            for sh, part in zip(shards, _split_leaf(leaf, TP_SPLIT[name],
                                                    mesh)):
                sh[name] = part
    return TpParams(mesh, shards)


def gather_params(tp_params: TpParams) -> Params:
    """``shard_params``' inverse, on shard 0's device: the shards'
    slices concatenated in shard order."""
    mesh, shards = tp_params.mesh, tp_params.shards
    out: Params = {"layers": {}}
    for name in shards[0]:
        if name == "layers":
            for lname in shards[0]["layers"]:
                out["layers"][lname] = _gather_leaf(
                    [sh["layers"][lname] for sh in shards], TP_SPLIT[lname],
                    mesh)
        else:
            out[name] = _gather_leaf([sh[name] for sh in shards],
                                     TP_SPLIT[name], mesh)
    return out


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of a params dict, in a fixed (sorted-key) order: the
    leaves a training step takes gradients of."""
    out = []
    for key in sorted(params):
        v = params[key]
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


def leaf_names(params: Params, prefix: str = "") -> List[str]:
    """``param_leaves``' leaves by path (``embed``, ``layers/wq``), in
    its order."""
    out = []
    for key in sorted(params):
        v = params[key]
        out.extend(leaf_names(v, f"{prefix}{key}/") if isinstance(v, dict)
                   else [prefix + key])
    return out


def _splits(key: str, mesh, layer: bool) -> Tuple[Optional[int], ...]:
    """A leaf's (tp, fsdp, ep, pp) axes on ``mesh``; None where the axis
    has one rank or does not split it. pp splits a ``layer`` leaf's L
    axis (a stage's layers; chunk-major under the interleaved schedule,
    ``parallel/pipeline.py::interleave_params``) and leaves the
    embeddings and the final norm whole on every stage."""
    return (TP_SPLIT.get(key) if mesh.tp > 1 else None,
            FSDP_SPLIT[key] if mesh.fsdp > 1 else None,
            EP_SPLIT.get(key) if mesh.ep > 1 else None,
            0 if layer and mesh.pp > 1 else None)


def leaf_splits(params: Params, mesh: TrainMesh
                ) -> List[Tuple[Optional[int], ...]]:
    """Each leaf's (tp axis, fsdp axis, ep axis, pp axis) on ``mesh``,
    in ``param_leaves``' order; None where the axis has one rank or does
    not split it."""
    return [_splits(name.rsplit("/", 1)[-1], mesh,
                    name.startswith("layers/"))
            for name in leaf_names(params)]


def check_layout(cfg: TransformerConfig, layout, batch_size: int,
                 seq_len: Optional[int] = None, n_microbatches: int = 2,
                 schedule: str = "1f1b", virtual_stages: int = 2) -> None:
    """Raise a ValueError when ``cfg`` or the batch cannot be laid out
    over ``layout`` (a ``ParallelLayout``): tp by ``check_tp``'s
    messages, fsdp over d_model, the batch over the data ranks, the
    experts over ep (and ep only with experts), under pp the pipeline's
    (``check_pipeline``), the sequence over sp, and under Ulysses each
    tp rank's heads over sp (the reference's messages)."""
    if layout.tp > 1:
        check_tp(cfg, layout.tp)
    if cfg.d_model % layout.fsdp:
        raise ValueError(f"d_model {cfg.d_model} not divisible by "
                         f"fsdp={layout.fsdp}")
    if batch_size % (layout.dp * layout.fsdp):
        raise ValueError(f"batch_size {batch_size} not divisible by the "
                         f"data ranks dp x fsdp = "
                         f"{layout.dp * layout.fsdp}")
    if layout.ep > 1:
        if cfg.n_experts == 0:
            raise ValueError(f"ep={layout.ep} needs experts: n_experts is "
                             f"0 (the dense FFN has none to split)")
        if cfg.n_experts % layout.ep:
            raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                             f"ep={layout.ep}")
    if layout.pp > 1:
        check_pipeline(cfg, layout, batch_size, n_microbatches, schedule,
                       virtual_stages)
    if layout.sp > 1:
        if seq_len is not None and seq_len % layout.sp:
            raise ValueError(f"seq_len {seq_len} not divisible by sp "
                             f"{layout.sp}")
        if cfg.sp_strategy == "ulysses":
            check_ulysses_heads(cfg.n_heads // layout.tp,
                                cfg.kv_heads // layout.tp, layout.sp)


PIPELINE_SCHEDULES = ("1f1b", "gpipe", "interleaved")


def check_pipeline(cfg: TransformerConfig, layout, batch_size: int,
                   n_microbatches: int, schedule: str,
                   virtual_stages: int) -> None:
    """The reference's refusals of a pipelined layout
    (``nos_tpu/parallel/pipeline.py``: ``make_pipeline_train_step``'s
    schedule, ``_check``, the GPipe sp composition's and the interleaved
    schedule's), in its order, with its messages; and a microbatch the
    data ranks do not split (each takes its share of every
    microbatch's rows)."""
    stages, sp = layout.pp, layout.sp
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if sp > 1 and schedule != "gpipe":
        raise ValueError(
            "1F1B does not compose with sp (ring attention): ring ppermutes "
            "inside the divergent 1F1B lax.cond mispair across pp rows — "
            "use the GPipe schedule (pipeline_forward/pipeline_loss_fn), "
            "whose uniform tick composes with manual sp")
    if cfg.n_layers % stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by pp {stages}")
    if batch_size % n_microbatches:
        raise ValueError(
            f"batch {batch_size} not divisible by n_microbatches "
            f"{n_microbatches}")
    data = layout.dp * layout.fsdp
    if (batch_size // n_microbatches) % data:
        raise ValueError(
            f"microbatch of {batch_size // n_microbatches} rows not "
            f"divisible by the data ranks dp x fsdp = {data}")
    if sp > 1 and cfg.n_experts > 0:
        raise ValueError(
            "GPipe sp composition is dense-only: per-shard MoE capacity "
            "routing diverges from global routing")
    if schedule == "interleaved":
        v = virtual_stages
        if cfg.n_layers % (stages * v):
            raise ValueError(
                f"n_layers {cfg.n_layers} not divisible by pp*virtual_stages "
                f"{stages}*{v}")
        if n_microbatches % stages:
            raise ValueError(
                f"interleaved schedule needs n_microbatches "
                f"({n_microbatches}) divisible by pp ({stages})")


def rank_params(params: Params, mesh: TrainMesh) -> Params:
    """This rank's part of full ``params`` (the reference's
    ``device_put(params, param_shardings(mesh, cfg))`` for one device):
    each leaf its tp slice, its fsdp slice, its experts and its stage's
    layers, a contiguous tensor of its own (the adamw kernel takes one
    leaf a launch)."""
    def part(name: str, leaf: torch.Tensor, layer: bool) -> torch.Tensor:
        return mesh.local_part(leaf, *_splits(name, mesh, layer))

    return {k: ({n: part(n, t, True) for n, t in v.items()}
                if k == "layers" else part(k, v, False))
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def attention_block(h_in: torch.Tensor, layer: dict, cfg: TransformerConfig,
                    freqs, attention_call,
                    mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """Pre-RMSNorm attention sublayer + residual. ``attention_call(q, k,
    v)`` takes/returns [B, S, H, D]; k/v stay at kv_heads (GQA grouped
    inside the attention op). q, k (after rope) and v come out of the
    ``qkv_proj`` op, the reference's ``"qkv_proj"`` tensors, and o out of
    the flash op (or the ring's output op), its ``"attn_out"``. Under tp
    the layer holds H/tp query and Hkv/tp kv heads, and the o product's
    partial sums are reduced over the tp ranks; under sp it holds its
    sequence chunk, rotated at its global positions."""
    b, s = h_in.shape[:2]
    tp = mesh.tp if mesh is not None else 1
    h = rms_norm(h_in, layer["attn_norm"])
    rows = rope_rows(freqs, None, s)
    if mesh is not None:
        h = mesh.copy_to_tp(h)
        if mesh.sp > 1:
            # this rank's chunk of the sequence: its global positions
            start = mesh.sp_index * s
            rows = rope_rows(freqs, torch.arange(start, start + s,
                                                 device=h.device))
    q, k, v = qkv_proj(h, layer["wq"], layer["wk"], layer["wv"], *rows,
                       cfg.n_heads // tp, cfg.kv_heads // tp)
    o = attention_call(q, k, v).reshape(b, s, cfg.d_model // tp)
    out = torch.matmul(o, layer["wo"])
    if mesh is not None:
        out = mesh.reduce_from_tp(out)
    return h_in + out


def dense_ffn_block(h_in: torch.Tensor, layer: dict,
                    mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """Pre-RMSNorm SwiGLU FFN sublayer + residual; under tp over d_ff/tp,
    the down product's partial sums reduced over the tp ranks."""
    h = rms_norm(h_in, layer["mlp_norm"])
    if mesh is None:
        return h_in + swiglu(h, layer["w_gate"], layer["w_up"],
                             layer["w_down"])
    y = swiglu(mesh.copy_to_tp(h), layer["w_gate"], layer["w_up"],
               layer["w_down"])
    return h_in + mesh.reduce_from_tp(y)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _token_nll(logits, targets, None).mean()


class _VocabParallelNLL(torch.autograd.Function):
    """Megatron's vocab-parallel cross-entropy: f32 logits [..., V/tp] of
    this tp rank's vocab rows [start, start + V/tp) -> each token's
    -log p(target) [...], from the all-reduced max, sum of exponentials
    and target logit (no rank holds the full logits). Its gradient is
    softmax - one-hot, on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, targets, start, mesh):
        n = logits.shape[-1]
        m = mesh.all_reduce_tp_(logits.amax(dim=-1, keepdim=True),
                                dist.ReduceOp.MAX)
        shifted = logits - m
        total = mesh.all_reduce_tp_(shifted.exp().sum(dim=-1, keepdim=True))
        local = targets[..., None].long() - start
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        picked = torch.where(inside, torch.gather(shifted, -1, local), 0.0)
        picked = mesh.all_reduce_tp_(picked)
        ctx.save_for_backward(shifted, total, local, inside)
        return (torch.log(total) - picked)[..., 0]

    @staticmethod
    def backward(ctx, g):
        shifted, total, local, inside = ctx.saved_tensors
        grad = torch.exp(shifted) / total
        grad.scatter_add_(-1, local, -inside.to(grad.dtype))
        return grad * g[..., None], None, None, None


def _token_nll(logits: torch.Tensor, targets: torch.Tensor,
               mesh: Optional[TrainMesh]) -> torch.Tensor:
    """Each token's -log p(target) from f32 logits: the whole vocab's,
    or this tp rank's columns of it."""
    if mesh is None or mesh.tp == 1:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return _VocabParallelNLL.apply(logits, targets,
                                   mesh.tp_index * logits.shape[-1], mesh)


def _chunk_nll(xc: torch.Tensor, tc: torch.Tensor, unembed: torch.Tensor,
               mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    logits = torch.matmul(xc, unembed).float()
    return _token_nll(logits, tc, mesh).sum()


def lm_head_loss(norm_w: torch.Tensor, unembed: torch.Tensor,
                 hidden: torch.Tensor, targets: torch.Tensor,
                 loss_chunk: int = 0,
                 mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """Final rms-norm + unembed + token cross-entropy. With loss_chunk > 0
    the sequence runs in checkpointed chunks (the reference's
    ``jax.checkpoint`` under ``lax.scan``), so the f32 [B, S, vocab]
    logits never exist at once: backward recomputes one [B, chunk,
    vocab] block at a time. Under tp ``unembed`` holds this rank's vocab
    columns and the loss is vocab-parallel, chunk by chunk; under sp the
    chunks cut this rank's sequence chunk, the loss its tokens' mean."""
    hidden = rms_norm(hidden, norm_w)
    if mesh is not None:
        hidden = mesh.copy_to_tp(hidden)
    b, s, _ = hidden.shape
    if loss_chunk and s > loss_chunk and s % loss_chunk != 0:
        where = (f"seq_len={s}" if mesh is None or mesh.sp == 1 else
                 f"the sp rank's sequence chunk seq_len / sp = {s}")
        raise ValueError(
            f"loss_chunk={loss_chunk} does not divide {where}; "
            f"chunking would be silently disabled and the full fp32 "
            f"[B,S,vocab] logits materialised — pick a divisor of the "
            f"sequence length")
    if loss_chunk and s > loss_chunk:
        total = hidden.new_zeros((), dtype=torch.float32)
        for c0 in range(0, s, loss_chunk):
            total = total + checkpoint(
                _chunk_nll, hidden[:, c0:c0 + loss_chunk],
                targets[:, c0:c0 + loss_chunk], unembed, mesh,
                use_reentrant=False)
        return total / (b * s)
    logits = torch.matmul(hidden, unembed).float()
    return _token_nll(logits, targets, mesh).mean()


# the reference's checkpoint names -> the registered ops whose outputs
# carry them: q, k (after rope) and v are ``qkv_proj``'s outputs; o and
# the kernel's lse ("attn_residuals", splash's residual name) are the
# flash op's two outputs, saved together. Under sp's ring the attention
# is no flash op: its output is the ``ring_attention_out`` op's, and it
# has no residual of that name
REMAT_NAMES = {
    "qkv_proj": torch.ops.nos_tpu_torch.qkv_proj.default,
    "attn_out": torch.ops.nos_tpu_torch.flash_attention_fwd.default,
    "attn_residuals": torch.ops.nos_tpu_torch.flash_attention_fwd.default,
}
_RING_NAMES = dict(REMAT_NAMES,
                   attn_out=torch.ops.nos_tpu_torch.ring_attention_out.default,
                   attn_residuals=None)
_SAVED_NAMES = {"except_mlp": ("qkv_proj", "attn_out", "attn_residuals"),
                "minimal": ("attn_out", "attn_residuals")}


def remat_saved_ops(policy: str, ring: bool = False) -> frozenset:
    """The ops whose outputs a layer's checkpoint keeps for backward
    under ``policy`` (the reference's ``_remat_policy``); every other op
    of the layer is recomputed; ``ring``: the layer's attention is sp's
    ring. "dots" is
    ``dots_with_no_batch_dims_saveable``: a product with no batch
    dimension is ``aten.mm`` (``torch.matmul`` folds a [..., d] x [d, f]
    product into one: the o, FFN and MoE router products) or the
    ``qkv_proj`` op (whose products are such), while a product over a
    batch dimension (the MoE's dispatch, expert and combine products;
    the plain attention's) is ``aten.bmm`` and is recomputed, as the
    flash op, which is no product, is. The named policies save the
    outputs of the ops in ``REMAT_NAMES`` (``_RING_NAMES`` under the
    ring: its output is saved, and the recompute re-runs the ring's
    rotations for its own backward, as the reference's partial
    evaluation re-runs its unnamed residuals)."""
    if policy == "full":
        return frozenset()
    if policy == "dots":
        return frozenset((torch.ops.aten.mm.default,
                          REMAT_NAMES["qkv_proj"]))
    names = _RING_NAMES if ring else REMAT_NAMES
    return frozenset(names[n] for n in _SAVED_NAMES[policy]) - {None}


def remat_context_fn(policy: str,
                     down: Optional[Callable[[], torch.Tensor]] = None,
                     ring: bool = False):
    """``context_fn`` for a layer's ``torch.utils.checkpoint``: saves the
    outputs of ``remat_saved_ops(policy)`` in the forward and hands them
    to the recompute in backward, which runs the rest of the layer
    again and stops after the last tensor backward needs (the
    checkpoint's early stop), so a product whose output only feeds the
    residual add is not re-run either. ``down()`` is the layer's dense
    down-projection weight as its body uses it (under fsdp the gathered
    tensor the body made last): its product (an ``aten.mm`` with it on
    the right) is not saved, because no backward reads its output, as
    the reference's partial evaluation drops it; the early stop ends
    before it, so it never re-runs. (Under MoE the last product is the
    combine's ``bmm``, which no policy saves.) A collective's output is
    never saved: none is among the ops."""
    ops = remat_saved_ops(policy, ring)
    if not ops:
        return noop_context_fn
    mm = torch.ops.aten.mm.default
    if mm not in ops:
        down = None

    def policy_fn(ctx, func, *args, **kwargs):
        if func in ops and not (func is mm and down is not None
                                and args[1].data_ptr()
                                == down().data_ptr()):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts,
                             policy_fn)


# each policy's re-run products in a layer's forward order; the last
# product (down, or the MoE's combine) never re-runs: the recompute
# stops at its inputs, the last tensors backward needs
_RERUN = {
    "full": ("qkv", "attention", "wo", "router", "dispatch", "ffn"),
    "dots": ("attention", "dispatch", "expert_ffn"),
    "except_mlp": ("wo", "router", "dispatch", "ffn"),
    "minimal": ("qkv", "wo", "router", "dispatch", "ffn"),
}


def remat_rerun_flops(cfg: TransformerConfig, batch: int, seq: int) -> dict:
    """What one training step's recompute re-runs under
    ``cfg.remat_policy``: ``products``, the FLOPs of the q/k/v, o, FFN
    (gate and up; with experts also the router, dispatch and down
    products) products it runs again over all layers, and
    ``attention_layers``, the layers whose flash forward it runs again
    (the caller counts that by its own convention). Derived from
    ``remat_saved_ops`` and the early stop (``remat_context_fn``); under
    "dots" the MoE's batched products re-run, the others are saved.
    Zero without ``cfg.remat``."""
    if not cfg.remat:
        return {"products": 0.0, "attention_layers": 0}
    t, d, f, e = batch * seq, cfg.d_model, cfg.d_ff, cfg.n_experts
    parts = {"qkv": 2 * t * d * (d + 2 * cfg.kv_dim), "wo": 2 * t * d * d}
    if e > 0:
        slots = batch * e * expert_capacity(seq, e,
                                            cfg.expert_capacity_factor)
        parts.update(router=2 * t * d * e, dispatch=2 * slots * seq * d,
                     ffn=3 * 2 * slots * d * f)
        parts["expert_ffn"] = parts["ffn"]
    else:
        parts.update(ffn=2 * 2 * t * d * f)
    names = _RERUN[cfg.remat_policy]
    return {"products": float(cfg.n_layers * sum(parts.get(n, 0)
                                                 for n in names)),
            "attention_layers": cfg.n_layers * ("attention" in names)}


def _attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mesh: Optional[TrainMesh] = None,
                    sp_strategy: str = "ring") -> torch.Tensor:
    """q, k, v: [B, S, H, D] -> [B, H, S, D], causal attention, back to
    [B, S, H, D]: ``attention``, or under sp > 1 the ring's (its output
    through ``ring_attention_out``) or Ulysses' over the sp ranks."""
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    if mesh is None or mesh.sp == 1:
        out = attention(q, k, v, causal=True)
    elif sp_strategy == "ring":
        out = ring_attention_out(ring_attention(q, k, v, mesh, causal=True))
    else:
        out = ulysses_attention(q, k, v, mesh, causal=True)
    return out.transpose(1, 2)


def _data_parallel(params: Params, mesh: TrainMesh) -> Params:
    """``params`` with each leaf's gradient averaged over the ranks that
    hold distinct tokens (``TrainMesh.grad_mean``): one all-reduce a
    leaf when backward has summed all of its uses."""
    def mean(name: str, leaf: torch.Tensor) -> torch.Tensor:
        return mesh.grad_mean(leaf, FSDP_SPLIT[name] is not None)

    return {k: ({n: mean(n, t) for n, t in v.items()} if k == "layers"
                else mean(k, v)) for k, v in params.items()}


def _embed(tokens: torch.Tensor, embed: torch.Tensor,
           mesh: Optional[TrainMesh]) -> torch.Tensor:
    """The embedding lookup; under tp of this rank's vocab rows (a token
    outside them looks up zeros), summed over the tp ranks."""
    if mesh is None or mesh.tp == 1:
        return F.embedding(tokens, embed)
    rows = embed.shape[0]
    local = tokens - mesh.tp_index * rows
    inside = ((local >= 0) & (local < rows))[..., None]
    x = torch.where(inside, F.embedding(local.clamp(0, rows - 1), embed),
                    0.0)
    return mesh.reduce_from_tp(x)


def run_layers(layers: Dict[str, torch.Tensor], cfg: TransformerConfig,
               x: torch.Tensor, freqs,
               mesh: Optional[TrainMesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked ``layers`` (leaves [K, ...]: all of the model's, or a
    pipeline stage's K) over the hidden state ``x`` [B, S, d] -> (y,
    each layer's MoE aux loss [K] f32, zeros on the dense path): the
    reference's layer scan, and its pipeline's ``_stage_fn_factory``.
    With ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` with ``remat_context_fn(cfg.remat_policy)``
    (without grad nothing is saved or recomputed, so the layer runs
    plainly). With ``mesh``: this rank's parts of the layers (its fsdp
    slices gathered just before use, inside the checkpoint) and the FFN
    ``moe_ffn_mesh``."""
    # the down weight as the body last used it, for the remat policy
    held = {}
    ring = mesh is not None and mesh.sp > 1 and cfg.sp_strategy == "ring"

    def attention_call(q, k, v):
        return _attention_call(q, k, v, mesh, cfg.sp_strategy)

    def layer_body(x, *tensors):
        layer = dict(zip(names, tensors))
        if mesh is not None:
            layer = {n: mesh.gather_fsdp(t, FSDP_SPLIT[n])
                     for n, t in layer.items()}
        held["w_down"] = layer["w_down"]
        x = attention_block(x, layer, cfg, freqs, attention_call, mesh)
        if cfg.n_experts > 0:
            h = rms_norm(x, layer["mlp_norm"])
            experts = (h, layer["w_router"], layer["w_gate"], layer["w_up"],
                       layer["w_down"])
            if mesh is None:
                y, aux = moe_ffn(*experts, cfg.expert_capacity_factor)
            else:
                y, aux = moe_ffn_mesh(*experts, mesh,
                                      cfg.expert_capacity_factor)
            return x + y, aux
        return (dense_ffn_block(x, layer, mesh),
                x.new_zeros((), dtype=torch.float32))

    names = sorted(layers)
    down = (lambda: held["w_down"]) if cfg.n_experts == 0 else None
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(layers[names[0]].shape[0]):
        tensors = [layers[n][i] for n in names]
        if remat:
            x, aux = checkpoint(layer_body, x, *tensors, use_reentrant=False,
                                context_fn=remat_context_fn(
                                    cfg.remat_policy, down, ring))
        else:
            x, aux = layer_body(x, *tensors)
        auxes.append(aux)
    return x, torch.stack(auxes)


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            return_aux: bool = False, return_hidden: bool = False,
            mesh: Optional[TrainMesh] = None):
    """tokens [B, S] -> logits [B, S, vocab] f32 (plus the MoE auxiliary
    loss, 0 on the dense path, when ``return_aux``). ``return_hidden``
    yields the pre-head hidden state [B, S, d_model] + aux instead, for
    ``loss_fn``, which applies the head itself (chunked). The layers run
    through ``run_layers``: with ``cfg.remat`` what the policy does not
    save is recomputed in backward (the attention kernel too under
    "full" and "dots"). With ``n_experts > 0`` each layer's FFN is
    ``moe_ffn`` and the aux loss is the mean of the layers' (each
    returned by the checkpointed body, so the recompute routes with the
    same bits under every policy). With ``mesh``: this rank's params
    (``rank_params``) and its batch rows' sequence chunk; the FFN is
    ``moe_ffn_mesh`` (the gating over the whole sequence, its
    statistics means over the data ranks: the reference's over the
    global batch), and its logits are its tp rank's vocab columns."""
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             tokens.device)
    x = _embed(tokens, params["embed"], mesh)
    x, auxes = run_layers(params["layers"], cfg, x, freqs, mesh)
    aux = auxes.mean()
    if return_hidden:
        return x, aux
    x = rms_norm(x, params["final_norm"])
    if mesh is not None:
        x = mesh.copy_to_tp(x)
    logits = torch.matmul(x, params["unembed"]).float()
    if return_aux:
        return logits, aux
    return logits


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def loss_fn(params: Params, cfg: TransformerConfig,
            batch: Dict[str, torch.Tensor],
            mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """The batch's mean token loss (+ the weighted MoE aux loss). With
    ``mesh``, this rank's: its tokens' mean (the aux loss over the data
    ranks' batch), whose mean over the data and sp ranks
    (``TrainMesh.token_mean``) is the step's."""
    hidden, aux = forward(params, cfg, batch["tokens"], return_hidden=True,
                          mesh=mesh)
    loss = lm_head_loss(params["final_norm"], params["unembed"], hidden,
                        batch["targets"], cfg.loss_chunk, mesh)
    return loss + cfg.moe_aux_weight * aux


def make_train_step(cfg: TransformerConfig, optimizer,
                    mesh: Optional[TrainMesh] = None):
    """Returns train_step(params, batch) -> loss (a detached f32 scalar
    tensor). ``params`` are leaf tensors with ``requires_grad`` and
    ``optimizer`` is ``nos_tpu_torch.train.optim.build_optimizer``'s,
    built over ``param_leaves(params)``: the step takes the gradients and
    updates the params IN PLACE (the reference donates them to its jitted
    step and rebinds the outputs). With ``mesh``, ``params`` are this
    rank's parts and ``batch`` its rows' sequence chunk; the loss
    returned is the step's, the mean over the data and sp ranks."""

    def train_step(params: Params, batch: Dict[str, torch.Tensor]):
        if mesh is None:
            loss = loss_fn(params, cfg, batch)
        else:
            loss = loss_fn(_data_parallel(params, mesh), cfg, batch, mesh)
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        return loss if mesh is None else mesh.token_mean(loss)

    return train_step
