"""Build and bind the port's CUDA kernels.

Each kernel source under ``nos_tpu_torch/csrc/`` has a plain C entry
point; it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``nos_tpu_torch/_build/`` (named by a hash of the source and of the
``csrc/*.cuh`` headers it includes, so an edit to either rebuilds) at
first use, and loaded with ``ctypes``. The library needs no ``-lcuda``:
the bf16 flash kernels build their TMA tensor maps in their C entries
with ``cuTensorMapEncodeTiled``, taken from the CUDA runtime's driver
entry-point table (``csrc/sm90.cuh``).
Nothing here touches CUDA when the module is imported, so the CPU tests
import it freely. Each wrapper checks what it is handed, allocates its
output with ``torch.empty``, launches on PyTorch's current stream, raises
on a non-zero ``cudaGetLastError()``, and counts its launches in
``launches`` (set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
HEAD_DIMS = (64, 128)
# paged_decode_attention.cu: the most blocks that split one row tile's
# live pages between them
MAX_SPLIT = 8


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use")


def _includes(source: Path) -> List[Path]:
    """The ``csrc`` headers ``source`` includes (``#include "x.cuh"``)."""
    text = source.read_text()
    return [CSRC / name for name in
            re.findall(r'^\s*#include\s+"([^"]+\.cuh)"', text, re.M)]


def _lib_path(source: Path) -> Path:
    """The library's name carries a hash of the source and of every
    header it includes, so an edit to either rebuilds it."""
    h = hashlib.sha256(source.read_bytes())
    for header in _includes(source):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` on ``source`` unless its library is built; the
    output lands under a temporary name that ``_finish`` renames."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(source: Path, proc: Optional[subprocess.Popen]) -> Path:
    out = _lib_path(source)
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)
    return out


def _build(source: Path) -> Path:
    """Compile ``source`` with ``nvcc`` unless its library is built."""
    return _finish(source, _start(source))


class _Kernel:
    """One CUDA source's library, built and loaded on first launch."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def fn(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(_build(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class _PagedDecode(_Kernel):
    """``csrc/paged_decode_attention.cu``: the counterpart of
    ``nos_tpu/ops/attention.py::paged_decode_attention``, one launch per
    call. The ``n_split`` blocks (``paged_splits``) of each (query-row
    tile, kv head, batch row) split the row's live pages, stream them
    through a ring of bulk copies, and merge their softmax states inside
    the launch: each leaves its state in a slot of a scratch and takes a
    ticket, and the last folds the slots in split order. The scratch and
    its tickets belong to one (device, stream): calls on one stream run
    in order and share them, while launches on two streams never touch
    each other's tickets. They are allocated at a stream's first call
    and grown when a call needs more (the kernel leaves the tickets at
    zero), so a call allocates only its output; a CUDA graph captures
    the scratch that a warm-up launch on its stream allocated."""

    def __init__(self):
        super().__init__(
            "paged_decode_attention.cu", "nos_paged_decode_attention",
            [_P] * 10 + [_I] * 7 + [_F, _I, _I, _I, _P])
        self._scratch: Dict[Tuple[torch.device, int], tuple] = {}

    def _part(self, device: torch.device, stream: int, floats: int,
              tickets: int):
        """(part, ticket) of at least these sizes for ``stream`` (its
        handle) on ``device``."""
        part, ticket = self._scratch.get((device, stream), (None, None))
        if part is None or part.numel() < floats \
                or ticket.numel() < tickets:
            part = torch.empty(floats, dtype=torch.float32, device=device)
            ticket = torch.zeros(tickets, dtype=torch.int32, device=device)
            self._scratch[(device, stream)] = (part, ticket)
        return part, ticket

    def launch(self, q: torch.Tensor, k_arena: torch.Tensor,
               v_arena: torch.Tensor, table: torch.Tensor,
               pos: torch.Tensor, *, k_scale: Optional[torch.Tensor],
               v_scale: Optional[torch.Tensor],
               scale: float) -> torch.Tensor:
        int8 = k_scale is not None
        tensors = [q, k_arena, v_arena, table, pos]
        if int8:
            tensors += [k_scale, v_scale]
        for t in tensors:
            if t.device.type != "cuda" or t.device != q.device:
                raise ValueError(
                    f"paged_decode_attention: every tensor must be on "
                    f"q's CUDA device {q.device}, got {t.device}")
            if not t.is_contiguous():
                raise ValueError(
                    "paged_decode_attention: inputs must be contiguous")
        b, h, s, d = q.shape
        nb_phys, h_kv, bs, d_kv = k_arena.shape
        nb = table.shape[1]
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"q dtype must be f32|bf16, got {q.dtype}")
        want = torch.int8 if int8 else q.dtype
        if k_arena.dtype != want or v_arena.dtype != want:
            raise ValueError(
                f"arena dtype must be {want} (q is {q.dtype}, "
                f"{'int8' if int8 else 'plain'} arena), got "
                f"{k_arena.dtype}/{v_arena.dtype}")
        if v_arena.shape != k_arena.shape or d_kv != d:
            raise ValueError(
                f"arena shapes {tuple(k_arena.shape)}/"
                f"{tuple(v_arena.shape)} do not match q {tuple(q.shape)}")
        if d not in HEAD_DIMS:
            raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {d}")
        if bs < 8 or bs & (bs - 1):
            raise ValueError(f"block size must be a power of two >= 8, "
                             f"got {bs}")
        if h % h_kv:
            raise ValueError(f"heads {h} must divide by kv heads {h_kv}")
        if table.dtype != torch.int32 or table.shape != (b, nb) \
                or pos.dtype != torch.int32 or pos.shape != (b,):
            raise ValueError("table must be int32 [B, nb] and pos int32 [B]")
        if int8 and (v_scale is None
                     or k_scale.dtype != torch.float32
                     or v_scale.dtype != torch.float32
                     or k_scale.shape != (nb_phys, h_kv, bs)
                     or v_scale.shape != (nb_phys, h_kv, bs)):
            raise ValueError(
                "int8 arena needs f32 k_scale and v_scale [NB, Hkv, bs]")
        if any(t.data_ptr() % 16 for t in tensors[1:3] + tensors[5:]):
            raise ValueError("paged_decode_attention: the arenas and scale "
                             "planes must be 16-byte aligned (bulk copies)")
        out = torch.empty_like(q)
        gs = h // h_kv * s
        tiles = b * h_kv * paged_row_tiles(gs)
        n_split = paged_splits(tiles, _sm_count(q.device))
        stream = _stream(q)
        part = ticket = None
        if n_split > 1:
            rows = 4 if gs <= 4 else 8
            part, ticket = self._part(
                q.device, stream, tiles * n_split * rows * (d + 2), tiles)
        rc = self.fn()(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None,
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            ticket.data_ptr() if ticket is not None else None,
            b, h, h_kv, s, d, bs, nb, float(scale), n_split,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_arena.dtype], stream)
        if rc != 0:
            raise RuntimeError(
                f"paged_decode_attention kernel launch failed: "
                f"cudaError {rc}")
        self.launches += 1
        return out


def paged_row_tiles(gs: int) -> int:
    """Query-row tiles of one kv head's ``gs = g * S`` rows: the kernel
    takes 4 rows a block when they fit (a decode step), else 8."""
    return -(-gs // (4 if gs <= 4 else 8))


def paged_splits(tiles: int, sms: int) -> int:
    """Blocks per (row tile, kv head, batch row) for ``tiles`` of them on
    ``sms`` SMs: the smallest power of two that gives the grid at least
    two blocks per SM, at most ``MAX_SPLIT``; 1 when the tiles alone
    fill the card. Chosen without reading ``pos``."""
    n = 1
    while n < MAX_SPLIT and tiles * n < 2 * sms:
        n *= 2
    return n


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The device's SM count, asked once per device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


paged_decode = _PagedDecode()


def _check_flash(name: str, tensors: List[torch.Tensor]) -> None:
    """Device, dtype, contiguity and 16-byte alignment of a flash
    kernel's tensors (the first sets the device and dtype; f32 row
    statistics are named by the caller after the others)."""
    ref = tensors[0]
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype must be f32|bf16, got {ref.dtype}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name}: every tensor must be on "
                             f"{ref.device} (CUDA), got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")


def _flash_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, causal: bool) -> tuple:
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v dtypes differ: {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.shape != (b, h_kv, s_k, d) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    if h % h_kv:
        raise ValueError(f"{name}: heads {h} must divide by kv heads {h_kv}")
    if causal and s_q > s_k:
        raise ValueError(f"{name}: the bottom-right causal mask needs "
                         f"Sq <= Sk, got {s_q} > {s_k}")
    return b, h, h_kv, s_q, s_k, d


def _rows_f32(name: str, t: torch.Tensor, shape: tuple,
              device: torch.device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: row statistics must be contiguous f32 "
                         f"{shape} on {device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class _FlashKernel(_Kernel):
    """One launch of ``csrc/flash_attention.cu``, the counterpart of the
    splash and flash kernels ``nos_tpu/ops/attention.py::attention``
    dispatches; the four launches share one library. In bf16 the
    forward, dK/dV and dQ launches run Hopper kernels: a producer warp
    streams tiles with TMA through a two-stage mbarrier ring while two
    consumer warpgroups run wgmma with their accumulators (O with the
    online softmax's state, or the gradients) in registers, each output
    summed by one block in a fixed order (no atomics, the same bits every
    run). f32 runs the scalar tiled kernels."""

    def __init__(self, symbol: str, argtypes: list):
        super().__init__("flash_attention.cu", symbol, argtypes)

    def _call(self, *args) -> None:
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1


class _FlashForward(_FlashKernel):
    def __init__(self):
        super().__init__("nos_flash_attention_fwd",
                         [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P])

    def launch(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, scale: float) -> tuple:
        """(o [B, H, Sq, D] in q's dtype, lse f32 [B, H, Sq])."""
        _check_flash("flash_attention_fwd", [q, k, v])
        b, h, h_kv, s_q, s_k, d = _flash_shapes("flash_attention_fwd",
                                                q, k, v, causal)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
        self._call(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), b, h, h_kv, s_q, s_k, d, float(scale),
                   int(causal), _DTYPE_CODE[q.dtype], _stream(q))
        return o, lse


class _FlashPreprocess(_FlashKernel):
    def __init__(self):
        super().__init__("nos_flash_attention_bwd_preprocess",
                         [_P] * 3 + [_I] * 3 + [_P])

    def launch(self, o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
        """delta = rowsum(dO * O), f32 [B, H, Sq]."""
        _check_flash("flash_attention_bwd_preprocess", [o, do])
        if do.shape != o.shape or do.dtype != o.dtype:
            raise ValueError("flash_attention_bwd_preprocess: dO must "
                             "match O in shape and dtype")
        if o.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"flash_attention_bwd_preprocess: head_dim "
                             f"must be one of {HEAD_DIMS}, got "
                             f"{o.shape[-1]}")
        delta = torch.empty(o.shape[:-1], dtype=torch.float32,
                            device=o.device)
        self._call(o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                   delta.numel(), o.shape[-1], _DTYPE_CODE[o.dtype],
                   _stream(o))
        return delta


class _FlashBackward(_FlashKernel):
    """The dK/dV launch (``dq=False``) or the dQ launch (``dq=True``)."""

    def __init__(self, dq: bool):
        n_out = 1 if dq else 2
        super().__init__(
            "nos_flash_attention_bwd_dq" if dq
            else "nos_flash_attention_bwd_dkdv",
            [_P] * (6 + n_out) + [_I] * 6 + [_F, _I, _I, _P])
        self.dq = dq

    def launch(self, q, k, v, do, lse, delta, *, causal: bool,
               scale: float) -> tuple:
        name = self.symbol[4:]
        _check_flash(name, [q, k, v, do])
        b, h, h_kv, s_q, s_k, d = _flash_shapes(name, q, k, v, causal)
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError(f"{name}: dO must match q in shape and dtype")
        _rows_f32(name, lse, (b, h, s_q), q.device)
        _rows_f32(name, delta, (b, h, s_q), q.device)
        outs = ((torch.empty_like(q),) if self.dq
                else (torch.empty_like(k), torch.empty_like(v)))
        self._call(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(),
                   *(t.data_ptr() for t in outs), b, h, h_kv, s_q, s_k, d,
                   float(scale), int(causal), _DTYPE_CODE[q.dtype],
                   _stream(q))
        return outs


flash_fwd = _FlashForward()
flash_bwd_pre = _FlashPreprocess()
flash_bwd_dkdv = _FlashBackward(dq=False)
flash_bwd_dq = _FlashBackward(dq=True)
class _AdamW(_Kernel):
    """``csrc/adamw.cu``: optax's adamw update of one parameter leaf in
    place, every operation rounded to the leaf's dtype as the
    reference's ops are; the plain version is
    ``train/optim.py::adamw_update_reference``. One launch per leaf."""

    def __init__(self):
        super().__init__("adamw.cu", "nos_adamw",
                         [_P] * 4 + [_I, _I] + [_F] * 9 + [_I, _P])

    def launch(self, p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, consts: Tuple[float, ...]) -> None:
        """``consts``: (1 - b1, b1, 1 - b2, b2, bc1, bc2, eps, wd, -lr),
        each a value of the leaf's dtype."""
        for t in (p, g, mu, nu):
            if t.device.type != "cuda" or t.device != p.device:
                raise ValueError(f"adamw: every tensor must be on p's CUDA "
                                 f"device {p.device}, got {t.device}")
            if t.dtype != p.dtype or t.shape != p.shape:
                raise ValueError("adamw: p, g, mu, nu must share one dtype "
                                 "and shape")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("adamw: tensors must be contiguous and "
                                 "16-byte aligned")
        if p.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"adamw: dtype must be f32|bf16, got {p.dtype}")
        if p.numel() >= 2 ** 31:
            raise ValueError(f"adamw: a leaf of {p.numel()} elements; the "
                             f"kernel takes fewer than 2^31")
        rc = self.fn()(p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                       nu.data_ptr(), p.numel(), _DTYPE_CODE[p.dtype],
                       *consts, _sm_count(p.device), _stream(p))
        if rc != 0:
            raise RuntimeError(f"adamw kernel launch failed: cudaError {rc}")
        self.launches += 1


adamw = _AdamW()

KERNELS: List[_Kernel] = [paged_decode, flash_fwd, flash_bwd_pre,
                          flash_bwd_dkdv, flash_bwd_dq, adamw]


def build_all() -> Dict[str, float]:
    """Build and load every kernel library: one ``nvcc`` per source, all
    started together; returns {source: seconds until its library was
    ready}."""
    t0 = time.perf_counter()
    sources = sorted({k.source for k in KERNELS})
    procs = {src: _start(src) for src in sources}
    out = {}
    for src in sources:
        _finish(src, procs[src])
        out[src.name] = time.perf_counter() - t0
    for k in KERNELS:
        k.fn()
    return out
