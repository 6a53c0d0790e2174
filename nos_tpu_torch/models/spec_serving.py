"""Speculative decoding inside the continuous-batching engine (port of
``nos_tpu/models/spec_serving.py``).

``SpeculativeDecodeServer`` is a ``DecodeServer`` with a draft model.
Each round the draft proposes ``n_draft`` = k tokens a slot (k S = 1
draft steps), the target verifies them in one S = k window, and each row
commits its own accepted prefix plus, at the first rejection, the
target's correction token: up to k tokens a round (a full accept commits
the k proposals; there is no bonus token). Acceptance, the correction
and the pos advance of both caches resolve inside the program, so a
rejection needs no host round trip, and the engine keeps the base
engine's dispatch economics: ``decode_steps`` = T rounds fused into one
program, ``pipeline_depth`` programs in flight, each program one CUDA
graph replay on the card, captured per sampling key.

Both arms of the base engine serve it:

- slot-static (``kv_blocks`` 0): the draft keeps ``[max_len]`` rows of
  its own cache; a request must leave room for the writes of every
  window in flight before pos rolls back (``submit``'s headroom guard);
- paged: the draft has its own arena with the target's block geometry
  and exclusively owned blocks (no prefix sharing; ``fork`` copies the
  committed draft blocks). Both tables grow over the span one dispatch
  can write, and once the window drains the tail blocks past the
  committed prefix go back to the pool (``_trim_spec_tails``), so a
  fork, a swap capture and the pool see only committed state. Under the
  kernel formulation the verify window runs the paged kernel's S = k
  path and the draft its S = 1 path at the draft's head_dim, each on its
  own split-merge scratch.

Greedy rows commit plain greedy decoding's tokens. Sampled rows use the
accept-reject rule with keys by (seed, absolute position, sub-stream:
0 draft draw, 1 accept uniforms, 2 residual draw), so a row's tokens do
not depend on its neighbours or on the dispatch knobs; they are the
reference engine's tokens at the same seed.

Under a mesh (``mesh=``, a ``TpMesh``) the draft splits as the target
does (``transformer.shard_params`` at the draft's widths) and its arena,
scale planes or slot-static rows are ``HeadShards`` on the head axis, so
the draft and target arenas split in lockstep while the draft's block
table, pos and control rows stay on shard 0's device beside the
target's; acceptance and sampling read the gathered f32 logit rows the
sharded forwards return (the reference's ``replicated_logits``).

The draft is derived state: a preempted or restored request's draft
cache is rebuilt for its committed sequence (``_resume_draft``). Under
the kernel formulation the draft re-prefills the prompt as its admission
did and replays each committed token through a captured one-step draft
program at the tick's width (``_replay_draft``), so the rebuilt draft
cache has the bits the undisturbed run wrote, and a sampled row's later
draws see the same proposal distribution. A recompute resume's target
output span is rewritten the same way: each committed round replays as
the S = k verify window that wrote it (``_replay_committed``, from the
rounds the request records), not as S = 1 steps, whose matmuls and
kernel path round differently.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np
import torch

from nos_tpu_torch.models.generate import (
    _truncate_logits_rows, check_mesh, forward_paged, forward_with_cache,
    init_cache, init_paged_cache,
)
from nos_tpu_torch.models.kvblocks import (
    BlockAllocator, NoFreeBlocks, ScaleLedger, blocks_for,
)
from nos_tpu_torch.models.serving import (
    DecodeServer, QueueFull, _bucket, _Request, install_row,
)
from nos_tpu_torch.models.speculative import _sample_rows
from nos_tpu_torch.models.transformer import (
    Params, TpParams, TransformerConfig, shard_params,
)
from nos_tpu_torch.ops import _kernels
from nos_tpu_torch.ops.attention import check_paged_kernel_head_dim
from nos_tpu_torch.utils import prng

__all__ = ["SpeculativeDecodeServer"]


def _row_dist(logits: torch.Tensor, temp: torch.Tensor, topk: torch.Tensor,
              topp: torch.Tensor) -> torch.Tensor:
    """Per-row tempered, truncated sampling distribution [B, V]: the one
    the plain engine samples from."""
    return torch.softmax(_truncate_logits_rows(
        logits / torch.clamp_min(temp, 1e-6)[:, None], topk, topp), dim=-1)


class SpeculativeDecodeServer(DecodeServer):
    """``DecodeServer`` with draft-verified ticks: each fused round
    commits up to ``n_draft`` tokens a slot. ``draft_params`` /
    ``draft_cfg`` are the draft model (same vocabulary as the target);
    every other knob is the base engine's."""

    def __init__(self, params: Params, cfg: TransformerConfig,
                 draft_params: Params, draft_cfg: TransformerConfig,
                 *, n_draft: int = 4, max_batch: int = 8,
                 max_len: Optional[int] = None, **kw):
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError("draft and target must share a vocabulary")
        if kw.get("role", "colocated") == "prefill":
            raise ValueError(
                "speculative decoding on a prefill-role engine is "
                "pointless: a prefill replica never decodes, so the "
                "draft would only burn HBM. Run the draft on the "
                "decode side (role=decode adopts handoffs and "
                "re-prefills the draft from the committed sequence) or "
                "colocated")
        mesh = kw.get("mesh")
        if mesh is not None and draft_cfg.kv_heads % check_mesh(mesh).tp:
            raise ValueError(
                f"draft kv_heads {draft_cfg.kv_heads} not divisible by "
                f"tp={mesh.tp}; the draft cache head axis cannot shard "
                f"evenly")
        super().__init__(params, cfg, max_batch=max_batch, max_len=max_len,
                         **kw)
        if mesh is not None:
            # the draft splits over the target's mesh, in lockstep: its
            # params in the same layout, its arena's head axis
            if draft_params is params:          # draft = target
                draft_params = self.params
            elif not isinstance(draft_params, TpParams):
                draft_params = shard_params(draft_params, draft_cfg, mesh)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.k = k = max(1, int(n_draft))
        # proposals drafted and accepted, and each verify window's
        # accepted count, parked (capped) for the serving loop's
        # histogram
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_window_events: List[int] = []
        self._chunked_drow: dict = {}   # rid -> chunk-prefilled draft row
        # rid -> draft blocks reserved when a chunked admission starts:
        # decoders grow draft blocks while it prefills, and its install
        # must not find the draft pool dry
        self._chunked_dreserved: dict = {}
        if self.paged:
            check_paged_kernel_head_dim(draft_cfg.head_dim, self.device,
                                        self.paged_kernel)
            self._d_alloc = BlockAllocator(self._alloc.num_blocks,
                                           self.kv_block_size)
            self._d_scales: Optional[ScaleLedger] = None
            if self.kv_dtype == "int8":
                self._d_scales = ScaleLedger()
                self._d_alloc.scale_ledger = self._d_scales
            self.d_cache = init_paged_cache(
                draft_cfg, self._alloc.num_blocks, self.kv_block_size,
                max_batch, kv_dtype=self.kv_dtype, device=self.device,
                mesh=mesh)
            self._d_tables: List[List[int]] = [[] for _ in range(max_batch)]
            self._d_deferred: List[int] = []
            self._d_table = torch.zeros((max_batch, self._nbs),
                                        dtype=torch.int32, device=self.device)
            # the draft replay program's table (only the resumed row
            # live) and the draft's own split-merge scratch: the draft's
            # launches and the target's are separate owners (none under
            # a mesh, whose shards' launches take the kernel's own)
            self._d_rtable = torch.zeros((max_batch, self._nbs),
                                         dtype=torch.int32,
                                         device=self.device)
            self._d_scratch = (_kernels.PagedScratch() if mesh is None
                               else None)
            # the window replay program's feed (a recompute resume's
            # rounds)
            self._wtoks = torch.zeros((max_batch, k), dtype=torch.long,
                                      device=self.device)
        else:
            self.d_cache = init_cache(draft_cfg, max_batch, self.max_len,
                                      per_row_pos=True, device=self.device,
                                      mesh=mesh)
            self._d_table = None
        self.replayed_windows = 0
        self.replayed_draft_tokens = 0
        # each round's committed tokens, count and accepted count:
        # [max_batch, T, k + 2], the one buffer a tick copies to the host
        self._toks = torch.zeros((max_batch, self.decode_steps, k + 2),
                                 dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens, **kw) -> int:
        """The base ``submit``; on the slot-static engine a request must
        also leave room below ``max_len`` for the verify windows in
        flight (``pipeline_depth * decode_steps * n_draft`` positions),
        whose writes would otherwise be clamped onto committed K/V. The
        paged engine routes overrun writes to the null block and needs
        no such room."""
        window = self.pipeline_depth * self.decode_steps * self.k
        if not self.paged and prompt \
                and len(prompt) + max_new_tokens + window > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) + draft window ({window}) exceeds "
                f"cache length {self.max_len}")
        return super().submit(prompt, max_new_tokens, **kw)

    # -- the tick ------------------------------------------------------
    def _d_forward(self, toks: torch.Tensor, cache: dict,
                   table: Optional[torch.Tensor]):
        """The draft model over ``cache`` (the draft's formulation of
        the target's ``_forward``, on the draft's scratch)."""
        if not self.paged:
            return forward_with_cache(self.draft_params, self.draft_cfg,
                                      toks, cache)
        return forward_paged(self.draft_params, self.draft_cfg, toks, cache,
                             table, paged_impl=self.paged_kernel,
                             scratch=self._d_scratch)

    def _spec_round(self, r: int, sampling: bool, t_table, d_table,
                    keep: torch.Tensor) -> torch.Tensor:
        """One draft + verify round in place: k draft steps, one S = k
        target window, per-row acceptance, the correction token, the
        committed tokens and counts into ``_toks[:, r]``, and both pos
        rows and ``_last`` advanced for the rows in ``keep``. Returns the
        window's logits."""
        k = self.k
        t_pos0 = self.cache["pos"]
        d_pos0 = self.d_cache["pos"]
        last = self._last
        b = last.shape[0]
        temp, topk, topp = self._temp, self._topk, self._topp
        seeds = prng.PRNGKey(self._seed)

        def row_keys(offs, stream: int) -> torch.Tensor:
            # the token being produced sits at t_pos0 + 1 + offs;
            # sub-streams 0/1/2: draft draw, accept uniforms, residual
            return prng.fold_in(seeds, (t_pos0.long() + 1 + offs) * 4
                                + stream)

        # 1. the draft proposes k tokens
        drafts, qs = [], []
        tok = last
        dc = self.d_cache
        for i in range(k):
            dlogits, dc = self._d_forward(tok, dc, d_table)
            step = dlogits[:, -1].float()
            nxt = torch.argmax(step, dim=-1)
            if sampling:
                q = _row_dist(step, temp, topk, topp)
                nxt = torch.where(temp > 0, _sample_rows(row_keys(i, 0), q),
                                  nxt)
                qs.append(q)
            tok = nxt[:, None]
            drafts.append(nxt)
        proposed = torch.stack(drafts, dim=1)               # [B, k]

        # 2. the target verifies in one window: logits[:, i] is its
        # verdict on proposed[:, i]
        feed = torch.cat([last, proposed[:, :-1]], dim=1)
        tlogits, _ = self._forward(feed, self.cache, t_table)
        tlogits = tlogits.float()
        greedy = torch.argmax(tlogits, dim=-1)              # [B, k]
        if sampling:
            v = tlogits.shape[-1]
            pdist = _row_dist(
                tlogits.reshape(b * k, v), temp.repeat_interleave(k),
                topk.repeat_interleave(k),
                topp.repeat_interleave(k)).reshape(b, k, v)
            qdist = torch.stack(qs, dim=1)                  # [B, k, V]
            px = pdist.gather(-1, proposed[..., None])[..., 0]
            qx = qdist.gather(-1, proposed[..., None])[..., 0]
            # one accept-u vector a row, keyed at the round's first
            # produced position; u[i] gates proposed[:, i]
            u = prng.uniform(row_keys(0, 1), (k,))
            accept = torch.where((temp > 0)[:, None], u * qx < px,
                                 proposed == greedy)
        else:
            accept = proposed == greedy

        # 3. each row's accepted prefix a in [0, k]
        stop = torch.cat([~accept, torch.ones((b, 1), dtype=torch.bool,
                                              device=accept.device)], dim=1)
        a = stop.int().argmax(dim=1)
        full = a == k
        # the correction at the first rejection: the target's argmax, or
        # a residual draw; a full accept needs none
        a_idx = a.clamp(max=k - 1)
        corr = greedy.gather(1, a_idx[:, None])[:, 0]
        if sampling:
            rows = torch.arange(b, device=a.device)
            p_a, q_a = pdist[rows, a_idx], qdist[rows, a_idx]
            resid = torch.clamp_min(p_a - q_a, 0.0)
            norm = resid.sum(dim=-1, keepdim=True)
            resid = torch.where(norm > 0, resid / norm, p_a)
            corr = torch.where(temp > 0,
                               _sample_rows(row_keys(a_idx, 2), resid), corr)

        # 4. committed tokens: proposed[:a], the correction, padding;
        # counts c = k on a full accept, else a + 1
        c = torch.where(full, torch.full_like(a, k), a + 1)
        j = torch.arange(k, device=a.device)[None, :]
        commit = torch.where(
            j < a[:, None], proposed,
            torch.where(j == a[:, None], corr[:, None],
                        torch.zeros_like(proposed)))
        new_last = commit.gather(1, (c - 1)[:, None])
        self._toks[:, r, :k].copy_(commit)
        self._toks[:, r, k].copy_(c)
        self._toks[:, r, k + 1].copy_(a)
        self._last.copy_(torch.where(keep[:, None], new_last, last))

        # 5. roll back by position: processed == committed[:-1]
        c32 = c.to(torch.int32)
        self.d_cache["pos"].copy_(torch.where(keep, d_pos0 + c32, d_pos0))
        t_pos0.copy_(torch.where(keep, t_pos0 + c32, t_pos0))
        return tlogits

    def _decode_program(self, sampling: bool) -> torch.Tensor:
        """The speculative tick on the engine's static buffers: T =
        ``decode_steps`` rounds, each reading the pos the previous one
        committed. Rows outside ``_keep`` keep their pos and feed token
        (their tables on the null block when paged). Writes both caches,
        both pos rows, ``_last`` and ``_toks``; returns the last
        window's logits."""
        keep = self._keep
        t_table = self._keep_table(self._table)
        d_table = self._keep_table(self._d_table)
        for r in range(self.decode_steps):
            logits = self._spec_round(r, sampling, t_table, d_table, keep)
        return logits

    def _replay_committed(self, req: _Request) -> None:
        """A recompute resume's target output span under the kernel
        formulation: each committed round replays as the verify window
        that wrote it (rows 0..count-1 the round's committed tokens at
        its start, the rest padding past the committed prefix), through
        the window replay program at the tick's width. A request with no
        recorded rounds (restored from another engine) takes the base
        engine's one-step replay."""
        if not req.rounds:
            return super()._replay_committed(req)
        s = req.slot
        seq = req.prompt + req.out
        self._rtable[s].copy_(self._table[s])
        for start, count in req.rounds:
            row = seq[start:start + count] + [0] * (self.k - count)
            self._wtoks[s].copy_(self._to_device(
                torch.tensor(row, dtype=torch.long)))
            self._rpos[s].fill_(start)
            self._launch_graph("wreplay")
        self._rtable[s].zero_()
        self._rpos[s].zero_()
        self._wtoks[s].zero_()
        self.replayed_tokens += len(req.out) - 1
        self.replayed_windows += len(req.rounds)

    def _wreplay_program(self) -> torch.Tensor:
        """One verify window of the window replay program on its static
        buffers (``_wtoks`` at ``_rpos`` through ``_rtable``); writes the
        target arena only."""
        view = {k: v for k, v in self.cache.items() if k != "pos"}
        view["pos"] = self._rpos
        logits, _ = self._forward(self._wtoks, view, self._rtable)
        return logits[:, -1].float()

    def _graph_scratch(self) -> tuple:
        if not self.paged:
            return super()._graph_scratch()
        return super()._graph_scratch() + (self._d_scratch.part,
                                           self._d_scratch.ticket)

    def _program_for(self, key) -> tuple:
        if key == "dreplay":
            return self._d_replay_program, self._d_rtable
        if key == "wreplay":
            return self._wreplay_program, self._rtable
        return super()._program_for(key)

    def capture_programs(self):
        """The base engine's captures, and the draft replay program on a
        paged engine under the kernel formulation (every resume, swap
        or recompute, rebuilds the draft through it); none on a mesh."""
        out = super().capture_programs()
        if self.device.type != "cuda" or not self.paged \
                or self.paged_kernel != "kernel" or self.mesh is not None:
            return out
        keys = ["dreplay"] + ([] if self.kv_swap else ["wreplay"])
        for key in keys:
            if key not in self._graphs:
                t0 = self.compile_s
                self._graphs[key] = self._capture(key)
                out[key] = self.compile_s - t0
        return out

    def _consume_payload(self, ent, toks, now: float) -> int:
        """Append one tick's rounds ([max_batch, T, k + 2]: committed
        tokens, count, accepted) to the requests, stopping at each one's
        end, and count proposals and acceptances."""
        k = self.k
        emitted = 0
        for s in ent.slots:
            req = self._active.get(s)
            if req is None or req.done:
                continue
            n = 0
            for rnd in toks[s]:
                if req.done:
                    break       # later rounds are pure rollback
                self.spec_drafted += k
                self.spec_accepted += rnd[k + 1]
                self.spec_window_events.append(rnd[k + 1])
                if len(self.spec_window_events) > 4096:
                    del self.spec_window_events[:2048]
                start, got = len(req.prompt) + len(req.out) - 1, 0
                for t in rnd[:rnd[k]]:
                    req.out.append(t)
                    req.note_token()
                    got += 1
                    if req.done:
                        break
                req.rounds.append((start, got))
                n += got
            emitted += n
            if n and now:
                req.led.note_tokens(n, now)
            self._note_tenant_tokens(req, n)
            self._chip_add(req.tenant, "decode", n)
            self._finish_if_done(req, admit=False)
        return emitted

    # -- draft admission -----------------------------------------------
    def _d_bucket(self, n: int) -> int:
        """A draft scratch row's length: the prompt's bucket, at least
        one block under paging (blocks install whole)."""
        b = min(_bucket(n), self.max_len)
        return max(b, self.kv_block_size) if self.paged else b

    def _fresh_drow(self, bucket: int) -> dict:
        row = init_cache(self.draft_cfg, 1, bucket, device=self.device,
                         mesh=self.mesh)
        row["pos"] = torch.tensor(0, dtype=torch.int32)
        return row

    def _d_prefill(self, seq: List[int]) -> dict:
        """The draft's one-shot prefill of ``seq`` over a scratch row in
        its bucket."""
        n = len(seq)
        bucket = self._d_bucket(n)
        row = self._fresh_drow(bucket)
        _, row = forward_with_cache(self.draft_params, self.draft_cfg,
                                    self._tokens(seq + [0] * (bucket - n)),
                                    row)
        return row

    def _attach_draft_chunks(self, ent: dict, req: _Request) -> None:
        """Chunk the draft's prefill beside the target's: each advance
        runs one target chunk and one draft chunk. The draft has no
        prefix cache, so its chunks cover the whole prompt."""
        chunk = self._prefill_chunk
        plen = len(req.prompt)
        ent["drow"] = self._fresh_drow(self._d_bucket(plen))
        ent["dtodo"] = deque(req.prompt[i:i + chunk]
                             for i in range(0, plen, chunk))
        req.draft_chunked = True

    def _start_chunked_static(self, req, m, mkey) -> bool:
        if not super()._start_chunked_static(req, m, mkey):
            return False
        self._attach_draft_chunks(self._prefilling[-1], req)
        return True

    def _start_chunked(self, req, m, mkey) -> bool:
        # the draft's install blocks are reserved up front; a dry draft
        # pool falls back to the one-shot path, which installs in the
        # tick that checked its headroom
        try:
            reserved = self._d_alloc.alloc_many(
                blocks_for(len(req.prompt), self.kv_block_size))
        except NoFreeBlocks:
            return False
        if not super()._start_chunked(req, m, mkey):
            for b in reserved:
                self._d_alloc.decref(b)
            return False
        self._chunked_dreserved[req.rid] = reserved
        self._attach_draft_chunks(self._prefilling[-1], req)
        return True

    def cancel(self, rid: int) -> bool:
        ok = super().cancel(rid)
        if self.paged:
            # a cancelled chunked admission's draft reservation
            for b in self._chunked_dreserved.pop(rid, None) or []:
                self._d_alloc.decref(b)
        return ok

    def _chunk_cost(self, ent) -> int:
        # the draft chunk rides the target chunk's charge; once the
        # target's queue is empty (a prefix hit skips target chunks) the
        # draft's chunks are charged at their own size
        if ent["todo"]:
            return len(ent["todo"][0])
        return len(ent["dtodo"][0])

    def _prefill_remaining(self, ent) -> int:
        # the entry retires when both queues are empty
        return max(sum(len(c) for c in ent["todo"]),
                   sum(len(c) for c in ent["dtodo"]))

    def _prefill_advance(self, ent) -> bool:
        if "dtodo" not in ent:
            # a target-only entry (a recompute resume's chunks)
            return super()._prefill_advance(ent)
        if ent["todo"]:
            super()._prefill_advance(ent)       # one target chunk
        if ent["dtodo"]:                        # one draft chunk
            ent["drow"] = self._d_chunk(ent["drow"], ent["dtodo"])
        if ent["todo"] or ent["dtodo"]:
            return False
        self._chunked_drow[ent["req"].rid] = ent["drow"]
        return True

    def _d_chunk(self, row: dict, todo: deque) -> dict:
        """One draft chunk forward over a scratch row: the next chunk of
        ``todo``, the last one padded to its bucket."""
        toks_list = todo.popleft()
        rem = len(toks_list)
        rbucket = _bucket(rem) if not todo else rem
        _, row = forward_with_cache(
            self.draft_params, self.draft_cfg,
            self._tokens(toks_list + [0] * (rbucket - rem)), row)
        return row

    def _install_draft_row(self, req: _Request, drow: dict,
                           plen: int) -> None:
        """Land a prefilled draft scratch row in ``req``'s slot: the
        whole row on the slot-static engine, block by block into the
        draft arena on the paged one (quantized under int8), into the
        blocks a chunked admission reserved or fresh ones."""
        slot = req.slot
        if not self.paged:
            return install_row(self.d_cache, slot, drow, plen)
        bs = self.kv_block_size
        for b in self._d_tables[slot]:      # stale leftovers (resume)
            self._d_alloc.decref(b)
        table = self._chunked_dreserved.pop(req.rid, None)
        if table is None:
            table = self._d_alloc.alloc_many(blocks_for(plen, bs))
        self._write_rows(drow, table, 0, cache=self.d_cache,
                         scales=self._d_scales)
        self._d_tables[slot] = table
        self._set_d_table_row(slot)
        self.d_cache["pos"][slot].fill_(plen)

    def _finish_prefill(self, req, row, step, *,
                        installed: bool = False) -> None:
        # the draft installs first: the request may finish inside the
        # base call and its slot go to the next request at once
        drow = self._chunked_drow.pop(req.rid, None)
        if drow is None:
            drow = self._d_prefill(req.prompt)
        self._install_draft_row(req, drow, len(req.prompt))
        super()._finish_prefill(req, row, step, installed=installed)

    def _finish_if_done(self, req, admit: bool = True) -> None:
        if req.done and req.slot >= 0:
            self.d_cache["pos"][req.slot].fill_(0)
        super()._finish_if_done(req, admit)

    def _resume_draft(self, req: _Request) -> None:
        """Rebuild the draft cache for a resumed request's committed
        sequence ``prompt + out[:-1]`` (draft pos = its length). Under
        the kernel formulation the prompt is re-prefilled as the draft's
        admission did (one-shot or the same chunks) and each committed
        output token replays through the draft's one-step program at the
        tick's width (``_replay_draft``); otherwise the whole sequence
        re-prefills one-shot, as the reference does."""
        seq = req.prompt + req.out[:-1]
        replay = self.paged and self.paged_kernel == "kernel"
        if not replay:
            self._install_draft_row(req, self._d_prefill(seq), len(seq))
            return
        plen = len(req.prompt)
        if req.draft_chunked:
            chunk = self._prefill_chunk
            drow = self._fresh_drow(self._d_bucket(plen))
            todo = deque(req.prompt[i:i + chunk]
                         for i in range(0, plen, chunk))
            while todo:
                drow = self._d_chunk(drow, todo)
        else:
            drow = self._d_prefill(req.prompt)
        # the install covers the committed span; the replay writes it
        self._install_draft_row(req, drow, plen)
        s = req.slot
        extra = blocks_for(len(seq), self.kv_block_size) - len(
            self._d_tables[s])
        if extra > 0:
            self._d_tables[s] += self._d_alloc.alloc_many(extra)
            self._set_d_table_row(s)
        if self._d_scales is not None:
            for b in self._d_tables[s]:
                self._d_scales.note_write(b)
        if len(seq) > plen:
            self._replay_draft(req)
        self.d_cache["pos"][s].fill_(len(seq))

    def _replay_draft(self, req: _Request) -> None:
        """Rewrite the draft's committed output span with the arithmetic
        the undisturbed run wrote it with: each committed token but the
        last through the draft replay program, one S = 1 draft step at
        the tick's width with only the resumed row's table live (the
        draft's twin of ``_replay_committed``)."""
        s = req.slot
        n0 = len(req.prompt)
        toks = self._to_device(torch.tensor(req.out[:-1], dtype=torch.long))
        self._d_rtable[s].copy_(self._d_table[s])
        for i in range(len(req.out) - 1):
            self._rtoks[s, 0].copy_(toks[i])
            self._rpos[s].fill_(n0 + i)
            self._launch_graph("dreplay")
        self._d_rtable[s].zero_()
        self._rpos[s].zero_()
        self.replayed_draft_tokens += len(req.out) - 1

    def _d_replay_program(self) -> torch.Tensor:
        """One draft step of the draft replay program on its static
        buffers (``_rtoks`` at ``_rpos`` through ``_d_rtable``); writes
        the draft arena only."""
        view = {k: v for k, v in self.d_cache.items() if k != "pos"}
        view["pos"] = self._rpos
        logits, _ = forward_paged(self.draft_params, self.draft_cfg,
                                  self._rtoks, view, self._d_rtable,
                                  paged_impl=self.paged_kernel,
                                  scratch=self._d_scratch)
        return logits[:, -1].float()

    # -- the paged draft-block discipline ------------------------------
    def _set_d_table_row(self, slot: int) -> None:
        row = np.zeros((self._nbs,), np.int32)
        blocks = self._d_tables[slot]
        row[:len(blocks)] = blocks
        self._d_table[slot].copy_(self._to_device(torch.from_numpy(row)))

    def _dispatch_span(self) -> int:
        # each fused round writes a whole verify window before rolling
        # back by pos
        return self.decode_steps * self.k

    def _grow_slot_blocks(self, s: int, start: int, end: int) -> None:
        super()._grow_slot_blocks(s, start, end)
        # the draft table grows over the same span (both timelines sit
        # at the committed length); its blocks are never shared, so
        # growth never copies
        bs = self.kv_block_size
        table = self._d_tables[s]
        changed = False
        try:
            for j in range(start // bs, (end - 1) // bs + 1):
                while len(table) <= j:
                    table.append(self._d_alloc.alloc())
                    changed = True
                if self._d_scales is not None:
                    self._d_scales.note_write(table[j])
        finally:
            if changed:
                self._set_d_table_row(s)

    def _free_slot_blocks(self, slot: int) -> None:
        super()._free_slot_blocks(slot)
        table, self._d_tables[slot] = self._d_tables[slot], []
        if self._inflight:
            self._d_deferred.extend(table)
        else:
            for b in table:
                self._d_alloc.decref(b)

    def _drain_deferred(self) -> None:
        super()._drain_deferred()
        if not self.paged or self._inflight:
            return
        for b in self._d_deferred:
            self._d_alloc.decref(b)
        self._d_deferred.clear()
        self._trim_spec_tails()

    def _trim_spec_tails(self) -> None:
        """With no tick in flight, a block past a slot's committed
        prefix holds only speculated, rolled-back writes: free those
        tails in both pools and point their table entries back at the
        null block, so the pool, a fork and a swap capture see exactly
        the committed footprint."""
        bs = self.kv_block_size
        pre = {ent["req"].slot for ent in self._prefilling}
        for s, req in list(self._active.items()):
            if s in pre or req.slot < 0:
                continue
            need = blocks_for(len(req.prompt) + len(req.out) - 1, bs)
            for tables, alloc, set_row in (
                    (self._tables, self._alloc, self._set_table_row),
                    (self._d_tables, self._d_alloc, self._set_d_table_row)):
                table = tables[s]
                if len(table) > need:
                    for b in table[need:]:
                        alloc.decref(b)
                    del table[need:]
                    set_row(s)

    def _admit_headroom(self, req) -> bool:
        if not super()._admit_headroom(req):
            return False
        # the draft pool must hold the install blocks plus one of
        # growth too: no prefix sharing shrinks the draft's need
        plen = len(req.prompt)
        cap_blocks = blocks_for(plen + req.max_new_tokens - 1,
                                self.kv_block_size)
        committed = plen + len(req.out) - 1 if req.preempted else plen
        base_need = blocks_for(committed, self.kv_block_size)
        need = min(base_need + 1, max(base_need, cap_blocks))
        return need <= self._d_alloc.free_count

    def _preempt_slot(self, slot: int, mode: str) -> None:
        super()._preempt_slot(slot, mode)
        # the draft's blocks free outright in both modes: it is
        # rebuilt at resume (``_resume_draft``), not carried
        for b in self._d_tables[slot]:
            self._d_alloc.decref(b)
        self._d_tables[slot] = []
        self.d_cache["pos"][slot].fill_(0)

    def fork(self, rid: int, **kw) -> int:
        """The base fork (the target's committed blocks shared by
        refcount); the draft's committed blocks are copied into fresh
        ones (the draft writes every round, so sharing would copy on the
        next dispatch anyway), and the fork's draft pos set, so its
        rounds run over the source's draft bits."""
        if not self.paged:
            raise RuntimeError("fork requires paged KV (kv_blocks > 0)")
        src = next((r for r in self._active.values() if r.rid == rid),
                   None)
        if src is not None:
            # check the draft pool before the base fork commits anything
            self._flush()
            src = next((r for r in self._active.values()
                        if r.rid == rid), None)
            if src is not None and src.slot >= 0 and not src.done:
                nblk = blocks_for(len(src.prompt) + len(src.out) - 1,
                                  self.kv_block_size)
                if nblk > self._d_alloc.free_count:
                    raise QueueFull(
                        f"fork needs {nblk} free draft-KV blocks, "
                        f"{self._d_alloc.free_count} free; retry after "
                        f"a completion")
        nrid = super().fork(rid, **kw)
        new = next(r for r in self._active.values() if r.rid == nrid)
        src = next(r for r in self._active.values() if r.rid == rid)
        base = len(new.prompt) + len(new.out) - 1
        nblk = blocks_for(base, self.kv_block_size)
        fresh = self._d_alloc.alloc_many(nblk)
        srcs = self._d_tables[src.slot][:nblk]
        idx_src = self._to_device(torch.tensor(srcs, dtype=torch.long))
        idx_dst = self._to_device(torch.tensor(fresh, dtype=torch.long))
        for name in ("k", "v", "k_scale", "v_scale"):
            plane = self.d_cache.get(name)
            if plane is not None:
                plane[:, idx_dst] = plane[:, idx_src]
        if self._d_scales is not None:
            for a, b in zip(srcs, fresh):
                self._d_scales.note_copy(a, b)
        self._d_tables[new.slot] = fresh
        self._set_d_table_row(new.slot)
        self.d_cache["pos"][new.slot].fill_(base)
        new.draft_chunked = src.draft_chunked
        new.rounds = list(src.rounds)
        return nrid

    def free_device_memory(self, free_cache: bool = True) -> None:
        self.draft_params = self.d_cache = None
        self._d_table = self._d_rtable = self._d_scratch = None
        self._wtoks = None
        super().free_device_memory(free_cache)

    def stats(self) -> dict:
        st = super().stats()
        spec = {
            "n_draft": self.k,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "acceptance": (round(self.spec_accepted / self.spec_drafted, 4)
                           if self.spec_drafted else None),
        }
        if self.paged:
            spec["draft_kv"] = {
                "blocks_total": self._d_alloc.capacity,
                "blocks_free": self._d_alloc.free_count,
                "blocks_used": self._d_alloc.used_count,
                "scaled_blocks": (self._d_scales.count
                                  if self._d_scales is not None else None),
            }
        st["speculative"] = spec
        return st
