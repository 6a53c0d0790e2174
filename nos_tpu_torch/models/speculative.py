"""Speculative decoding, the library API (port of
``nos_tpu/models/speculative.py``): a small draft model proposes
``n_draft`` tokens, the target verifies them in one forward.

Greedy (temperature 0): a proposal is accepted while it equals the
target's argmax, so the output is token for token plain greedy decoding
of the target. Sampling (temperature > 0): proposal x_i is accepted with
probability ``min(1, p_i(x_i) / q_i(x_i))`` (p the target's, q the
draft's tempered and truncated distribution, as ``generate`` samples
from), and the first rejection draws from the normalized residual
``max(p_i - q_i, 0)``; the draws come from ``rng`` in the reference's
order (``split`` into draft, accept and residual keys each round), so a
seed gives the reference's tokens.

Rows advance in lockstep by the least acceptance of the batch (a scalar
``pos``); rolling speculation back is setting ``pos``. The serving twin,
with per-row advance, is ``models/spec_serving.SpeculativeDecodeServer``.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models.generate import (
    _prompt_tensor, _tempered, _truncate_logits, forward_with_cache,
    init_cache,
)
from nos_tpu_torch.models.transformer import Params, TransformerConfig
from nos_tpu_torch.utils import prng

__all__ = ["speculative_generate"]


def _dist(logits: torch.Tensor, temperature: float, top_k: int,
          top_p: float) -> torch.Tensor:
    """The tempered, truncated sampling distribution [..., vocab], the
    same for draft and target so the accept-reject identity holds."""
    return torch.softmax(
        _truncate_logits(_tempered(logits, temperature), top_k, top_p),
        dim=-1)


def _sample_rows(key: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """A draw from explicit probabilities [B, vocab] -> [B]: one key
    over the batch, or keys [B, 2], one a row."""
    logp = torch.where(probs > 0, torch.log(torch.clamp_min(probs, 1e-38)),
                       torch.full_like(probs, float("-inf")))
    return prng.categorical(key, logp)


def speculative_generate(
    params: Params, cfg: TransformerConfig, draft_params: Params,
    draft_cfg: TransformerConfig,
    prompt: Union[torch.Tensor, List[List[int]]], max_new_tokens: int, *,
    n_draft: int = 4, max_len: Optional[int] = None,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
    rng: Optional[torch.Tensor] = None, device: DeviceLike = None,
) -> torch.Tensor:
    """prompt [B, S] -> [B, S + max_new_tokens]. Greedy: the tokens of
    ``generate(params, cfg, prompt, max_new_tokens)``. Sampling: each
    token is distributed as ``generate(..., temperature, top_k, top_p)``
    samples it; ``rng`` is a ``utils.prng`` key."""
    device = resolve_device(device)
    prompt = _prompt_tensor(prompt, device)
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    if temperature > 0 and rng is None:
        raise ValueError("temperature sampling needs an rng key")
    if temperature <= 0 and (top_k or top_p):
        raise ValueError(
            "top_k/top_p only apply when sampling — set temperature > 0 "
            "(greedy decoding ignores truncation)")
    if top_k < 0 or not (0.0 <= top_p <= 1.0):
        raise ValueError(
            f"top_k must be >= 0 and top_p in [0, 1]: got "
            f"top_k={top_k}, top_p={top_p}")
    sampling = temperature > 0
    max_len = max_len or min(cfg.max_seq, draft_cfg.max_seq)
    # headroom: a round writes up to k positions past the accepted
    # prefix before rolling back
    k = max(1, min(n_draft, max_new_tokens))
    if s + max_new_tokens + k > max_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) + draft "
            f"window ({k}) exceeds cache length {max_len}")
    if sampling:
        rng = rng.to(device)

    # between rounds both caches have processed sequence[:-1], and
    # ``last`` [B, 1] is the newest token, not yet fed
    t_cache = init_cache(cfg, b, max_len, device=device)
    d_cache = init_cache(draft_cfg, b, max_len, device=device)
    if s > 1:
        _, t_cache = forward_with_cache(params, cfg, prompt[:, :-1],
                                        t_cache)
        _, d_cache = forward_with_cache(draft_params, draft_cfg,
                                        prompt[:, :-1], d_cache)
    last = prompt[:, -1:]
    pieces = []
    produced = 0
    while produced < max_new_tokens:
        base = int(t_cache["pos"])
        if sampling:
            rng, kd, kacc, kres = prng.split(rng, 4)
            dkeys = prng.split(kd, k)

        # 1. the draft proposes k tokens from ``last``
        drafts, qs = [], []
        tok = last
        for i in range(k):
            logits, d_cache = forward_with_cache(draft_params, draft_cfg,
                                                 tok, d_cache)
            if sampling:
                q = _dist(logits[:, -1], temperature, top_k, top_p)
                tok = _sample_rows(dkeys[i], q)[:, None]
                qs.append(q)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            drafts.append(tok)
        proposed = torch.cat(drafts, dim=1)                 # [B, k]

        # 2. the target verifies in one pass: position i is its verdict
        # on proposed[:, i]
        feed = torch.cat([last, proposed[:, :-1]], dim=1)
        logits, t_cache = forward_with_cache(params, cfg, feed, t_cache)

        # 3. acceptance per row and position
        if sampling:
            p = _dist(logits, temperature, top_k, top_p)    # [B, k, V]
            q = torch.stack(qs, dim=1)
            px = p.gather(-1, proposed[..., None])[..., 0]
            qx = q.gather(-1, proposed[..., None])[..., 0]
            u = prng.uniform(kacc, (b, k))
            accept = u * qx < px
        else:
            greedy = torch.argmax(logits, dim=-1)           # [B, k]
            accept = proposed == greedy

        # 4. advance by the least accepted prefix over the rows, plus a
        # correction token there (rows that accepted further commit
        # their own token and re-propose the rest next round)
        stop = torch.cat([~accept, torch.ones((b, 1), dtype=torch.bool,
                                              device=device)], dim=1)
        min_a = int(stop.int().argmax(dim=1).min())
        if min_a == k:                                      # full accept
            new = proposed
            last = proposed[:, -1:]
        else:
            if sampling:
                resid = torch.clamp_min(p[:, min_a] - q[:, min_a], 0.0)
                norm = resid.sum(dim=-1, keepdim=True)
                resid = torch.where(norm > 0, resid / norm, p[:, min_a])
                corr = torch.where(accept[:, min_a], proposed[:, min_a],
                                   _sample_rows(kres, resid))[:, None]
            else:
                corr = greedy[:, min_a:min_a + 1]
            new = torch.cat([proposed[:, :min_a], corr], dim=1)
            last = corr
            # positions base..base+min_a hold [last, d1..d_min_a]
            rolled = torch.tensor(base + min_a + 1, dtype=torch.int32,
                                  device=device)
            t_cache = {**t_cache, "pos": rolled}
            d_cache = {**d_cache, "pos": rolled.clone()}
        pieces.append(new)
        produced += new.shape[1]

    tail = torch.cat(pieces, dim=1)[:, :max_new_tokens]
    return torch.cat([prompt, tail], dim=1)
