"""Serving-binary config and engine factory (port of ``ServerConfig``
and ``build_engine`` from ``nos_tpu/cmd/server.py``).

``ServerConfig`` carries the fields this slice reads; ``build_engine``
validates them with the reference's messages, then rejects every knob
the torch engine does not serve yet by name, before any weights are
made. The HTTP ``ServingLoop`` is the next slice's work.
"""
from __future__ import annotations

from dataclasses import dataclass

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.ops.attention import check_paged_kernel_head_dim


@dataclass
class ServerConfig:
    # model
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 0
    d_ff: int = 1408
    max_seq: int = 512
    n_experts: int = 0
    bf16: bool = True
    checkpoint_dir: str = ""
    int8: bool = False
    # serving
    max_batch: int = 8
    max_pending: int = 0
    tp: int = 0
    role: str = "colocated"
    decode_pool: str = ""
    prefix_cache_size: int = 0
    prefill_chunk: int = 0
    prefill_budget: int = 0
    pipeline_depth: int = 1
    decode_steps: int = 1
    # paged KV cache: kv_blocks x kv_block_size tokens in one pooled
    # arena; kv_block_size a power of two >= 8 dividing max_seq
    kv_block_size: int = 0
    kv_blocks: int = 0
    kv_swap: bool = True
    kv_dtype: str = "bf16"
    # "on": paged attention runs the hand-written CUDA kernel
    # (ops.attention.paged_decode_attention); "off": the gather
    # formulation. Inert without kv_blocks.
    paged_kernel: str = "on"
    kv_hbm_admit_frac: float = 0.95
    kv_host_tier_bytes: int = 0
    draft_checkpoint_dir: str = ""
    draft_n_tokens: int = 4
    seed: int = 0
    tenant_config: str = ""


def build_engine(cfg: ServerConfig, device: DeviceLike = None):
    """Make params (seeded, int8 twin when ``cfg.int8``) and build the
    continuous-batching engine on ``device`` (default: the card). The
    paged attention formulation goes to the engine as its
    ``paged_impl``; nothing is written to the environment."""
    from nos_tpu_torch.cmd.generate import GenerateConfig, load_params
    from nos_tpu_torch.models.serving import DecodeServer, reject_unported

    # config errors must fire BEFORE the (multi-GB) weights are made
    if cfg.prefill_chunk and (cfg.prefill_chunk < 8 or
                              cfg.prefill_chunk & (cfg.prefill_chunk - 1)):
        raise ValueError(
            f"prefill_chunk must be 0 or a power of two >= 8, got "
            f"{cfg.prefill_chunk}")
    if cfg.prefill_budget < 0:
        raise ValueError(
            f"prefill_budget must be >= 0, got {cfg.prefill_budget}")
    if cfg.prefill_budget and not cfg.prefill_chunk:
        raise ValueError(
            "prefill_budget requires chunked prefill (set "
            "prefill_chunk): the budget schedules chunk forwards, and "
            "without chunking there is nothing to budget")
    if cfg.pipeline_depth < 1:
        raise ValueError(
            f"pipeline_depth must be >= 1, got {cfg.pipeline_depth}")
    if cfg.decode_steps < 1:
        raise ValueError(
            f"decode_steps must be >= 1, got {cfg.decode_steps}")
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(
            f"kv_dtype must be bf16|int8, got {cfg.kv_dtype!r}")
    if cfg.kv_dtype == "int8" and not cfg.kv_blocks:
        raise ValueError(
            "kv_dtype=int8 requires the paged KV cache: set "
            "kv_blocks/kv_block_size (the slot-static engine has no "
            "per-block scale storage, so int8 KV is not supported "
            "there) — or run kv_dtype=bf16")
    if cfg.paged_kernel not in ("on", "off"):
        raise ValueError(
            f"paged_kernel must be on|off, got {cfg.paged_kernel!r}")
    # the kernel walks per-slot block tables, so without kv_blocks
    # "on" is inert
    paged_impl = ("kernel" if cfg.paged_kernel == "on" and cfg.kv_blocks
                  else "xla")
    if cfg.draft_checkpoint_dir and cfg.draft_n_tokens < 1:
        raise ValueError(
            f"draft_n_tokens must be >= 1, got {cfg.draft_n_tokens}")
    if cfg.kv_blocks:
        bs = cfg.kv_block_size
        if bs < 8 or bs & (bs - 1):
            raise ValueError(
                f"kv_block_size must be a power of two >= 8 when "
                f"kv_blocks is set, got {bs}")
        if cfg.max_seq % bs:
            raise ValueError(
                f"max_seq {cfg.max_seq} must be a multiple of "
                f"kv_block_size {bs}")
        if cfg.kv_blocks < 2:
            raise ValueError(
                f"kv_blocks must be >= 2 (one reserved null block plus "
                f"at least one usable), got {cfg.kv_blocks}")
    if cfg.role not in ("colocated", "prefill", "decode"):
        raise ValueError(
            f"role must be colocated|prefill|decode, got {cfg.role!r}")
    if cfg.role != "colocated" and not cfg.kv_blocks:
        raise ValueError(
            f"role={cfg.role} requires the paged KV cache (set "
            f"kv_blocks/kv_block_size): the prefill->decode handoff "
            f"payload is the paged swap format — quantized blocks + "
            f"per-block scales — which the slot-static engine cannot "
            f"produce or adopt")
    if cfg.role == "prefill" and not cfg.decode_pool.strip():
        raise ValueError(
            "role=prefill requires --decode-pool (comma-separated "
            "decode-replica base URLs): a prefill server with nowhere "
            "to ship its handoffs would strand every request after "
            "its first token")
    if cfg.role == "prefill" and cfg.draft_checkpoint_dir:
        raise ValueError(
            "role=prefill with speculative decoding is pointless: a "
            "prefill replica never decodes, so the draft would only "
            "burn HBM — run the draft on the decode side "
            "(role=decode re-prefills it from each adopted handoff) "
            "or colocated")
    if cfg.kv_host_tier_bytes < 0:
        raise ValueError(
            f"kv_host_tier_bytes must be >= 0, got "
            f"{cfg.kv_host_tier_bytes}")
    if cfg.kv_host_tier_bytes and not (cfg.kv_blocks
                                       and cfg.prefix_cache_size):
        raise ValueError(
            "kv_host_tier_bytes requires the paged KV cache with a "
            "prefix cache (set kv_blocks/kv_block_size AND "
            "prefix_cache_size): the host tier stores demoted prefix "
            "chains, which only the paged prefix index produces — "
            "without one there is nothing to demote")
    # knobs outside this slice, by name, still before any weights
    for knob, on, what in (
            ("tp", cfg.tp > 1, "tensor-parallel serving"),
            ("draft_checkpoint_dir", cfg.draft_checkpoint_dir,
             "speculative decoding"),
            ("tenant_config", cfg.tenant_config, "tenant quotas"),
            ("kv_host_tier_bytes", cfg.kv_host_tier_bytes, "host KV tier"),
            ("checkpoint_dir", cfg.checkpoint_dir, "checkpoint loading")):
        if on:
            raise ValueError(
                f"{knob} is not ported to the torch engine yet ({what})")
    reject_unported(
        kv_blocks=cfg.kv_blocks, prefix_cache_size=cfg.prefix_cache_size,
        prefill_chunk=cfg.prefill_chunk, prefill_budget=cfg.prefill_budget,
        pipeline_depth=cfg.pipeline_depth, decode_steps=cfg.decode_steps,
        role=cfg.role, kv_swap=cfg.kv_swap)
    device = resolve_device(device)
    check_paged_kernel_head_dim(cfg.d_model // cfg.n_heads, device,
                                paged_impl)
    gcfg = GenerateConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, n_experts=cfg.n_experts, bf16=cfg.bf16,
        int8=cfg.int8, seed=cfg.seed)
    model_cfg, params = load_params(gcfg, device)
    return DecodeServer(params, model_cfg, max_batch=cfg.max_batch,
                        max_pending=cfg.max_pending,
                        kv_block_size=cfg.kv_block_size,
                        kv_blocks=cfg.kv_blocks,
                        hbm_admit_frac=cfg.kv_hbm_admit_frac,
                        kv_dtype=cfg.kv_dtype, device=device,
                        paged_impl=paged_impl)
