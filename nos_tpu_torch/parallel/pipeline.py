"""Pipeline parallelism over a ``TrainMesh``'s pp axis (port of
``nos_tpu/parallel/pipeline.py``): the layer stack split into P stages,
stage p's layers on the ranks of pp index p, microbatches flowing stage
to stage in lockstep ticks.

The reference runs one SPMD program under ``shard_map`` with ``pp``
manual, each tick a ``lax.cond``/``lax.switch`` over the stage's unit
and two ``ppermute``s. Here each rank is a process that runs the same
static tick tables: at a tick a stage runs its unit (forward, backward
or idle: an idle tick launches no stage compute) and then every pp rank
joins the tick's hop (``TrainMesh.pp_hop``: the activations to p + 1
and the cotangents to p - 1 in one all-reduce), so the gang stays in
step. A unit's own collectives (tp, fsdp, sp, ep, the MoE's data mean)
run on groups of one pp index, among the ranks that run that unit at
that tick.

Microbatch m is the global batch's rows [m mb, (m + 1) mb), each data
rank holding its share of them (``microbatch_rows``), as the reference
reshapes its global batch; so the MoE's aux statistics are means over
the data ranks per microbatch.

- **GPipe** (the reference's ``pipeline_loss_fn``): T = M + P - 1
  forward ticks under autograd, each stage keeping every microbatch's
  graph (M boundary inputs live); the head over the whole hidden state
  on the last stage; then the backward drains in reverse over the
  backward hop. The only schedule that composes with sp (dense models).
- **1F1B** (the reference's ``_make_1f1b_op``): 2M + 2P - 2 ticks,
  stage p's fwd(m) at t = p + 2m without autograd, its input saved in
  slot m % P (P slots, not M), and bwd(m) at t = 2P - 1 - p + 2m: the
  stage recomputed from that input under autograd and backpropagated
  from the received cotangent, or at the last stage from the head's
  loss scaled 1/M, with the aux loss's constant cotangent
  ``moe_aux_weight / (L M)``.
- **Interleaved 1F1B** (the reference's ``_make_interleaved_op``): each
  stage holds v chunks of K/v layers (chunk-major params,
  ``interleave_params``), the host tables of ``_InterleavedSchedule``
  (copied from the reference) giving each (tick, stage) its unit, chunk
  and microbatch and the receive routing into ``[v, R]`` buffers.

Stage 0 keeps each microbatch's d(embedded input) and backpropagates
them through the embedding once after the schedule. Then the loss and
the embedding's and head's gradients are summed over pp (every stage
applies the same update to the leaves it holds whole), and every
leaf's gradient is averaged over the ranks holding distinct tokens,
once (``TrainMesh.grad_mean_``). Eval runs each schedule's forward
only: GPipe's forward, 1F1B's fill-drain, the interleaved
``fwd_only`` tables.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from nos_tpu_torch.models import transformer as tfm

__all__ = ["Pipeline", "make_pipeline_train_step", "microbatch_rows",
           "interleave_layer_order", "interleave_params",
           "deinterleave_params"]

# a tick's unit
IDLE, FWD, BWD = 0, 1, 2


class _InterleavedSchedule:
    """Static tick tables for interleaved 1F1B (host-side numpy; a copy
    of the reference's class)."""

    IDLE, FWD, BWD = IDLE, FWD, BWD

    def __init__(self, P: int, v: int, M: int, fwd_only: bool = False):
        self.P, self.v, self.M = P, v, M
        V = P * v
        # canonical Megatron unit order (device-independent; microbatches
        # advance in groups of P, cycling chunks within a group)
        fwd_order = [(c, g * P + i) for g in range(M // P)
                     for c in range(v) for i in range(P)]
        bwd_order = [(c, g * P + i) for g in range(M // P)
                     for c in reversed(range(v)) for i in range(P)]
        orders = []
        for p in range(P):
            if fwd_only:
                orders.append([(self.FWD, c, m) for c, m in fwd_order])
                continue
            warm = min((P - p - 1) * 2 + (v - 1) * P, v * M)
            units = [(self.FWD, c, m) for c, m in fwd_order[:warm]]
            fi, bi = warm, 0
            while fi < v * M or bi < v * M:
                if fi < v * M:
                    units.append((self.FWD,) + fwd_order[fi])
                    fi += 1
                if bi < v * M:
                    units.append((self.BWD,) + bwd_order[bi])
                    bi += 1
            orders.append(units)

        # greedy lockstep simulation: each tick, a device runs its next
        # unit iff its producers completed on an EARLIER tick (the hop
        # delivers at end-of-tick), else idles
        done_f: dict = {}           # global chunk, m -> completion tick
        done_b: dict = {}
        ptr = [0] * P
        rows = []
        t = 0
        limit = 4 * (2 * v * M + 2 * V)
        while any(ptr[p] < len(orders[p]) for p in range(P)):
            if t > limit:
                raise RuntimeError("interleaved schedule did not converge")
            row = []
            ran = []
            for p in range(P):
                if ptr[p] >= len(orders[p]):
                    row.append((self.IDLE, 0, 0))
                    continue
                ut, cs, m = orders[p][ptr[p]]
                c = cs * P + p
                if ut == self.FWD:
                    ready = c == 0 or done_f.get((c - 1, m), t) < t
                else:
                    ready = done_f.get((c, m), t) < t and (
                        c == V - 1 or done_b.get((c + 1, m), t) < t)
                if ready:
                    row.append((ut, cs, m))
                    ran.append((p, ut, c, m))
                    ptr[p] += 1
                else:
                    row.append((self.IDLE, 0, 0))
            for p, ut, c, m in ran:
                (done_f if ut == self.FWD else done_b)[(c, m)] = t
            rows.append(row)
            t += 1
        self.T = len(rows)

        self.unit = np.array([[r[p][0] for p in range(P)] for r in rows],
                             np.int32)
        self.slot = np.array([[r[p][1] for p in range(P)] for r in rows],
                             np.int32)
        self.mb = np.array([[r[p][2] for p in range(P)] for r in rows],
                           np.int32)

        # receive-routing: what lands on device p at END of tick t.
        # fwd ring: sender p-1; its fwd of chunk c<V-1 is my chunk c+1
        # input. bwd ring: sender p+1; its bwd of chunk c>0 is my chunk
        # c-1 cotangent.
        self.rf_slot = np.full((self.T, P), -1, np.int32)
        self.rf_mb = np.zeros((self.T, P), np.int32)
        self.rg_slot = np.full((self.T, P), -1, np.int32)
        self.rg_mb = np.zeros((self.T, P), np.int32)
        for tt in range(self.T):
            for p in range(P):
                sp = (p - 1) % P
                ut, cs, m = rows[tt][sp]
                c = cs * P + sp
                if ut == self.FWD and c < V - 1:
                    self.rf_slot[tt, p] = (c + 1) // P
                    self.rf_mb[tt, p] = m
                sp = (p + 1) % P
                ut, cs, m = rows[tt][sp]
                c = cs * P + sp
                if ut == self.BWD and c > 0:
                    self.rg_slot[tt, p] = (c - 1) // P
                    self.rg_mb[tt, p] = m

        self._size_buffers(rows, fwd_only)

    def _size_buffers(self, rows, fwd_only):
        """Ring depth R: smallest R with no live-slot collision under
        ``m % R`` indexing, for the activation buffer (fwd store -> bwd
        consume) and both receive buffers (store -> consume). Validated
        by interval overlap, not guessed."""
        P, v = self.P, self.v
        intervals: dict = {}   # (kind, p, slot) -> list of (start, end, m)
        use_f: dict = {}
        for t in range(self.T):
            for p in range(P):
                ut, cs, m = rows[t][p]
                c = cs * P + p
                if ut == self.FWD:
                    if c > 0:
                        # consume inbuf_f (stored when upstream ran)
                        intervals.setdefault(("f", p, cs), []).append(
                            (use_f.pop(("f", p, cs, m)), t, m))
                    if not fwd_only:
                        use_f[("a", p, cs, m)] = t   # act stored now
                elif ut == self.BWD:
                    intervals.setdefault(("a", p, cs), []).append(
                        (use_f.pop(("a", p, cs, m)), t, m))
                    if c < P * v - 1:
                        intervals.setdefault(("g", p, cs), []).append(
                            (use_f.pop(("g", p, cs, m)), t, m))
                rf = self.rf_slot[t, p]
                if rf >= 0:
                    use_f[("f", p, int(rf), int(self.rf_mb[t, p]))] = t
                rg = self.rg_slot[t, p]
                if rg >= 0:
                    use_f[("g", p, int(rg), int(self.rg_mb[t, p]))] = t
        self._intervals = intervals
        R = 1
        while not self.ring_ok(R) and R < self.M:
            R += 1
        self.R = max(R, 1)

    def ring_ok(self, R: int) -> bool:
        """No two live (overlapping-interval) occupants of any buffer
        share a ``m % R`` slot. Always true at R == M (m is unique mod
        M), so callers picking a SHARED ring depth across schedules can
        bump to a common safe value (collision-freedom does not transfer
        between non-divisible moduli)."""
        for ivs in self._intervals.values():
            for i, (s1, e1, m1) in enumerate(ivs):
                for s2, e2, m2 in ivs[i + 1:]:
                    if m1 % R == m2 % R and m1 != m2 \
                            and s1 <= e2 and s2 <= e1:
                        return False
        return True

    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule (per-device idle ticks / total).
        The plain-1F1B analog is (2P-2)/(2M+2P-2); interleaving divides
        the fill/drain term ~v x (tick granularity is K/v layers)."""
        work = int((self.unit != self.IDLE).sum())
        return 1.0 - work / float(self.T * self.P)


def _shared_ring(sched: _InterleavedSchedule,
                 sched_f: _InterleavedSchedule, M: int) -> int:
    """One ring depth for the training and the forward-only tables,
    validated against each (the reference's ``_make_interleaved_op``)."""
    R = max(sched.R, sched_f.R)
    while not (sched.ring_ok(R) and sched_f.ring_ok(R)) and R < M:
        R += 1
    return R


def interleave_layer_order(n_layers: int, stages: int, v: int) -> list:
    """Chunk-major layer permutation: device p's v chunks (global chunks
    p, p+P, ..., p+(v-1)P) become CONTIGUOUS in the layer dim, so a
    stage's layers are one slice of each layer leaf. Checkpoints of an
    interleaved run store this order (stamped ``layer_order``)."""
    if n_layers % (stages * v):
        raise ValueError(
            f"n_layers {n_layers} not divisible by pp*virtual_stages "
            f"{stages}*{v}: a floored chunk size would silently DROP the "
            f"trailing layers")
    K = n_layers // (stages * v)
    order = []
    for p in range(stages):
        for k in range(v):
            c = k * stages + p
            order.extend(range(c * K, (c + 1) * K))
    return order


def _permute_layers(params: tfm.Params, idx) -> tfm.Params:
    out = dict(params)
    out["layers"] = {k: w[torch.as_tensor(idx, device=w.device)]
                     for k, w in params["layers"].items()}
    return out


def _n_layers(params: tfm.Params) -> int:
    return next(iter(params["layers"].values())).shape[0]


def interleave_params(params: tfm.Params, stages: int, v: int
                      ) -> tfm.Params:
    """Full params in chunk-major layer order."""
    return _permute_layers(params, interleave_layer_order(
        _n_layers(params), stages, v))


def deinterleave_params(params: tfm.Params, stages: int, v: int
                        ) -> tfm.Params:
    """Inverse of ``interleave_params``: restore canonical layer order."""
    return _permute_layers(params, np.argsort(np.asarray(
        interleave_layer_order(_n_layers(params), stages, v))))


def microbatch_rows(batch: int, n_microbatches: int, data_size: int,
                    data_index: int) -> torch.Tensor:
    """The global batch rows a data rank holds under pp: its share of
    each microbatch's rows [m mb, (m + 1) mb), in microbatch order."""
    mb = batch // n_microbatches
    share = mb // data_size
    return torch.cat([torch.arange(m * mb + data_index * share,
                                   m * mb + (data_index + 1) * share)
                      for m in range(n_microbatches)])


class Pipeline:
    """One rank's pipeline over ``mesh`` (a ``TrainMesh`` with pp > 1):
    the schedule's tables, its loss with the step's gradients
    (``loss_and_grads``) and without (``loss``). ``stats`` after a run:
    the schedule's ticks, the stage's busy units, the bubble fraction
    (idle share of the ticks over all stages, from the tables), and the
    most stage inputs this rank held at once (``peak_saved``: P under
    1F1B, M under GPipe, slots counted)."""

    def __init__(self, cfg: tfm.TransformerConfig, mesh,
                 n_microbatches: int = 2, schedule: str = "1f1b",
                 virtual_stages: int = 2):
        if schedule not in tfm.PIPELINE_SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.cfg, self.mesh = cfg, mesh
        self.M, self.P = n_microbatches, mesh.pp
        self.schedule = schedule
        self.v = virtual_stages if schedule == "interleaved" else 1
        if schedule == "interleaved":
            self.sched = _InterleavedSchedule(self.P, self.v, self.M)
            self.sched_f = _InterleavedSchedule(self.P, self.v, self.M,
                                                fwd_only=True)
            self.R = _shared_ring(self.sched, self.sched_f, self.M)
        self.aux_ct = torch.tensor(
            cfg.moe_aux_weight / (cfg.n_layers * self.M),
            dtype=torch.float32, device=mesh.device)
        self.stats: dict = {}

    # -- pieces ------------------------------------------------------------
    def _chunk(self, params: tfm.Params, cs: int) -> Dict[str, torch.Tensor]:
        """Chunk slot ``cs`` of this stage's layers (views of the leaves,
        so gradients accumulate into them)."""
        layers = params["layers"]
        k = _n_layers(params) // self.v
        return {n: t[cs * k:(cs + 1) * k] for n, t in layers.items()}

    def _stage(self, layers, x: torch.Tensor):
        """(y, the stage's aux loss sum) of one unit over ``x``."""
        y, auxes = tfm.run_layers(layers, self.cfg, x, self.freqs,
                                  self.mesh)
        return y, auxes.sum()

    def _head(self, params: tfm.Params, y: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
        return tfm.lm_head_loss(params["final_norm"], params["unembed"], y,
                                targets, self.cfg.loss_chunk, self.mesh)

    def _backward(self, y: torch.Tensor, g: torch.Tensor,
                  aux: torch.Tensor) -> None:
        """Backprop the unit's output ``y`` (the stage's, or the head's
        loss) from ``g`` and the stage's aux sum from the aux term's
        constant cotangent."""
        outs, grads = [y], [g]
        if aux.requires_grad:
            outs.append(aux)
            grads.append(self.aux_ct)
        torch.autograd.backward(outs, grads)

    def _hop(self, x, fwd, bwd):
        return self.mesh.pp_hop(x, fwd, bwd, self.mb_shape, self.cfg.dtype)

    def _setup(self, params: tfm.Params, batch: dict) -> None:
        tokens = batch["tokens"]
        self.freqs = tfm.rope_frequencies(
            self.cfg.head_dim, self.cfg.max_seq, self.cfg.rope_theta,
            tokens.device)
        self.mbl = tokens.shape[0] // self.M
        self.mb_shape = (self.mbl, tokens.shape[1], self.cfg.d_model)
        self.targets = batch["targets"].split(self.mbl)
        self.live = self.peak = 0

    def _hold(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def _embedded(self, params: tfm.Params, tokens: torch.Tensor):
        """Stage 0's embedded microbatches (the lookup's graph kept in
        training: their gradients go back through it once)."""
        x = tfm._embed(tokens, params["embed"], self.mesh)
        return x, [m.detach() for m in x.split(self.mbl)]

    def _finish(self, params: tfm.Params, loss: torch.Tensor, units: int,
                ticks: int, train: bool) -> torch.Tensor:
        """The loss summed over pp and averaged over the token ranks;
        in training each leaf's gradient completed (zeros where this
        stage has none, the whole leaves' summed over pp, every leaf's
        averaged over the token ranks once)."""
        mesh = self.mesh
        if train:
            for k, v in sorted(params.items()):
                for name, leaf in (sorted(v.items()) if k == "layers"
                                   else [(k, v)]):
                    if leaf.grad is None:
                        leaf.grad = torch.zeros_like(leaf)
                    if k != "layers":
                        mesh.pp_sum_(leaf.grad)
                    mesh.grad_mean_(leaf.grad,
                                    tfm.FSDP_SPLIT[name] is not None)
        loss = mesh.token_mean(mesh.pp_sum_(loss))
        self.stats = {"schedule": self.schedule, "ticks": ticks,
                      "units": units, "peak_saved": self.peak,
                      "bubble_fraction": self.bubble_fraction(train)}
        return loss

    def bubble_fraction(self, train: bool = True) -> float:
        """The schedule's idle share over all stages' ticks (the
        interleaved tables' own; 1F1B's (2P - 2) / (2M + 2P - 2), GPipe's
        and fill-drain's (P - 1) / (M + P - 1))."""
        P, M = self.P, self.M
        if self.schedule == "interleaved":
            return (self.sched if train else self.sched_f).bubble_fraction()
        if self.schedule == "1f1b" and train:
            return (2 * P - 2) / (2 * M + 2 * P - 2)
        return (P - 1) / (M + P - 1)

    # -- entry points --------------------------------------------------------
    def loss_and_grads(self, params: tfm.Params, batch: dict
                       ) -> torch.Tensor:
        """The step's loss (f32, detached; the mean over the token
        ranks); the leaves' ``.grad`` hold the step's gradients."""
        self._setup(params, batch)
        run = {"gpipe": self._gpipe, "1f1b": self._1f1b,
               "interleaved": self._interleaved}[self.schedule]
        return run(params, batch, train=True)

    @torch.no_grad()
    def loss(self, params: tfm.Params, batch: dict) -> torch.Tensor:
        """The loss alone, by the schedule's forward-only run."""
        self._setup(params, batch)
        run = {"gpipe": self._gpipe, "1f1b": self._fill_drain,
               "interleaved": self._interleaved}[self.schedule]
        return run(params, batch, train=False)

    # -- GPipe -----------------------------------------------------------
    def _gpipe(self, params, batch, train: bool) -> torch.Tensor:
        P, M, p = self.P, self.M, self.mesh.pp_index
        loss = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        if p == 0:
            emb, xs = self._embedded(params, batch["tokens"])
        layers, saved, recv, units = params["layers"], {}, None, 0
        for t in range(M + P - 1):
            m = t - p
            y = None
            if 0 <= m < M:
                x = xs[m] if p == 0 else recv
                if train:
                    x = x.detach().requires_grad_()
                y, aux = self._stage(layers, x)
                saved[m] = (x, y, aux)
                self._hold(1)
                loss = loss + self.aux_ct * aux.detach()
                units += 1
            recv, _ = self._hop(y, [q for q in range(P - 1)
                                    if 0 <= t - q < M], [])
        if p == P - 1:
            outs = [saved[m][1] for m in range(M)]
            if train:
                outs = [y.detach().requires_grad_() for y in outs]
            head = self._head(params, torch.cat(outs),
                              batch["targets"])
            if train:
                head.backward()
            loss = loss + head.detach()
        if not train:
            return self._finish(params, loss, units, M + P - 1, False)
        dxs, recv = [None] * M, None
        for r in range(M + P - 1):
            m = M - 1 - (r - (P - 1 - p))
            d_x = None
            if 0 <= m < M:
                x, y, aux = saved.pop(m)
                g = outs[m].grad if p == P - 1 else recv
                self._backward(y, g, aux)
                self.live -= 1
                d_x = x.grad
                if p == 0:
                    dxs[m] = d_x
                units += 1
            _, recv = self._hop(d_x, [], [q for q in range(1, P)
                                          if 0 <= M - 1 - (r - (P - 1 - q))
                                          < M])
        if p == 0:
            emb.backward(torch.cat(dxs))
        return self._finish(params, loss, units, 2 * (M + P - 1), True)

    # -- 1F1B --------------------------------------------------------------
    def _1f1b_unit(self, t: int, q: int):
        """Stage q's unit at tick t: (FWD or BWD, microbatch), or
        (IDLE, -1)."""
        P, M = self.P, self.M
        rel = t - q
        if rel >= 0 and rel % 2 == 0 and rel // 2 < M:
            return FWD, rel // 2
        b = t - (2 * P - 1 - q)
        if b >= 0 and b % 2 == 0 and b // 2 < M:
            return BWD, b // 2
        return IDLE, -1

    def _1f1b(self, params, batch, train: bool) -> torch.Tensor:
        P, M, p = self.P, self.M, self.mesh.pp_index
        loss = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        if p == 0:
            emb, xs = self._embedded(params, batch["tokens"])
        layers = params["layers"]
        act: List[Optional[torch.Tensor]] = [None] * P   # P slots, not M
        dxs = [None] * M
        recv_f = recv_g = None
        units = 0
        T = 2 * M + 2 * P - 2
        for t in range(T):
            unit, m = self._1f1b_unit(t, p)
            send = None
            if unit == FWD:
                x = xs[m] if p == 0 else recv_f
                with torch.no_grad():
                    send, _ = self._stage(layers, x)
                act[m % P] = x
                self._hold(1)
            elif unit == BWD:
                x = act[m % P].detach().requires_grad_()
                act[m % P] = None
                self.live -= 1
                y, aux = self._stage(layers, x)
                if p == P - 1:
                    # the head's loss, scaled 1/M, backpropagated with
                    # the stage in one pass
                    head = self._head(params, y, self.targets[m])
                    loss = loss + head.detach() / M
                    self._backward(head, torch.full_like(head, 1.0 / M),
                                   aux)
                else:
                    self._backward(y, recv_g, aux)
                loss = loss + self.aux_ct * aux.detach()
                send = x.grad
                if p == 0:
                    dxs[m] = send
            if unit != IDLE:
                units += 1
            units_t = [self._1f1b_unit(t, q)[0] for q in range(P)]
            recv_f, recv_g = self._hop(
                send, [q for q in range(P - 1) if units_t[q] == FWD],
                [q for q in range(1, P) if units_t[q] == BWD])
        if p == 0:
            emb.backward(torch.cat(dxs))
        return self._finish(params, loss, units, T, True)

    def _fill_drain(self, params, batch, train: bool) -> torch.Tensor:
        """1F1B's forward-only loss: T = M + P - 1 ticks of fwd units,
        the head at the last stage a microbatch, scaled 1/M."""
        P, M, p = self.P, self.M, self.mesh.pp_index
        loss = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        if p == 0:
            _, xs = self._embedded(params, batch["tokens"])
        recv, units = None, 0
        for t in range(M + P - 1):
            m = t - p
            y = None
            if 0 <= m < M:
                y, aux = self._stage(params["layers"],
                                     xs[m] if p == 0 else recv)
                if p == P - 1:
                    loss = loss + self._head(params, y,
                                             self.targets[m]) / M
                loss = loss + self.aux_ct * aux
                units += 1
            recv, _ = self._hop(y, [q for q in range(P - 1)
                                    if 0 <= t - q < M], [])
        return self._finish(params, loss, units, M + P - 1, False)

    # -- interleaved -------------------------------------------------------
    def _interleaved(self, params, batch, train: bool) -> torch.Tensor:
        P, M, p, v, R = self.P, self.M, self.mesh.pp_index, self.v, self.R
        V = P * v
        s = self.sched if train else self.sched_f
        loss = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        if p == 0:
            emb, xs = self._embedded(params, batch["tokens"])
        # [v, R] buffers: saved inputs, received inputs and cotangents
        act = [[None] * R for _ in range(v)]
        inf = [[None] * R for _ in range(v)]
        ing = [[None] * R for _ in range(v)]
        dxs = [None] * M
        units = 0
        for t in range(s.T):
            ut, cs, m = (int(a[t, p]) for a in (s.unit, s.slot, s.mb))
            c = cs * P + p
            send = None
            if ut == FWD:
                if c == 0:
                    x = xs[m]
                else:
                    x, inf[cs][m % R] = inf[cs][m % R], None
                with torch.no_grad():
                    send, aux = self._stage(self._chunk(params, cs), x)
                if train:
                    act[cs][m % R] = x
                    self._hold(1)
                else:
                    if c == V - 1:
                        loss = loss + self._head(params, send,
                                                 self.targets[m]) / M
                    loss = loss + self.aux_ct * aux
                if c == V - 1:
                    send = None
            elif ut == BWD:
                x = act[cs][m % R].detach().requires_grad_()
                act[cs][m % R] = None
                self.live -= 1
                y, aux = self._stage(self._chunk(params, cs), x)
                if c == V - 1:
                    head = self._head(params, y, self.targets[m])
                    loss = loss + head.detach() / M
                    self._backward(head, torch.full_like(head, 1.0 / M),
                                   aux)
                else:
                    g, ing[cs][m % R] = ing[cs][m % R], None
                    self._backward(y, g, aux)
                loss = loss + self.aux_ct * aux.detach()
                send = x.grad
                if c == 0:
                    dxs[m] = send
                    send = None
            if ut != IDLE:
                units += 1
            fwd = [q for q in range(P) if s.unit[t, q] == FWD
                   and s.slot[t, q] * P + q < V - 1]
            bwd = [q for q in range(P) if s.unit[t, q] == BWD
                   and s.slot[t, q] * P + q > 0]
            recv_f, recv_g = self._hop(send, fwd, bwd)
            if s.rf_slot[t, p] >= 0:
                inf[s.rf_slot[t, p]][s.rf_mb[t, p] % R] = recv_f
            if s.rg_slot[t, p] >= 0:
                ing[s.rg_slot[t, p]][s.rg_mb[t, p] % R] = recv_g
        if train and p == 0:
            emb.backward(torch.cat(dxs))
        return self._finish(params, loss, units, s.T, train)


def make_pipeline_train_step(cfg: tfm.TransformerConfig, optimizer, mesh,
                             n_microbatches: int = 2,
                             schedule: str = "1f1b",
                             virtual_stages: int = 2):
    """The pipelined ``make_train_step``: train_step(params, batch) ->
    the step's loss (the mean over the token ranks), the params (this
    rank's stage's layers and the whole embeddings and head) updated in
    place. ``train_step.pipeline`` is the ``Pipeline`` (its ``stats``
    and forward-only ``loss``)."""
    pipe = Pipeline(cfg, mesh, n_microbatches, schedule, virtual_stages)

    def train_step(params: tfm.Params, batch: Dict[str, torch.Tensor]):
        loss = pipe.loss_and_grads(params, batch)
        optimizer.step()
        return loss

    train_step.pipeline = pipe
    return train_step
