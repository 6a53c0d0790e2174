"""Build and bind the port's CUDA kernels.

Each kernel source under ``nos_tpu_torch/csrc/`` has a plain C entry
point; it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``nos_tpu_torch/_build/`` (named by the source's hash, so an
edited source rebuilds) at first use, and loaded with ``ctypes``.
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
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
HEAD_DIMS = (64, 128)
# paged_decode_attention.cu's block shape: query rows per block and
# tokens per staged chunk (a split of the timeline is whole chunks)
_ROWS, _CHUNK = 16, 32


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


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def _build(source: Path) -> Path:
    """Compile ``source`` with ``nvcc`` unless its library is built; the
    output lands under a temporary name and is renamed on success."""
    out = _lib_path(source)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


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
    ``nos_tpu/ops/attention.py::paged_decode_attention``."""

    def __init__(self):
        super().__init__(
            "paged_decode_attention.cu", "nos_paged_decode_attention",
            [_P] * 9 + [_I] * 7 + [_F, _I, _I, _I, _P])

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
        out = torch.empty_like(q)
        split_tok, n_split = _split(b, h // h_kv * s, h_kv, nb * bs,
                                    q.device)
        part = (torch.empty(b * h_kv * n_split * (h // h_kv * s) * (d + 2),
                            dtype=torch.float32, device=q.device)
                if n_split > 1 else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = self.fn()(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None,
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, h, h_kv, s, d, bs, nb, float(scale), split_tok,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_arena.dtype], stream)
        if rc != 0:
            raise RuntimeError(
                f"paged_decode_attention kernel launch failed: "
                f"cudaError {rc}")
        self.launches += 1
        return out


def _split(b: int, gs: int, h_kv: int, timeline: int,
           device: torch.device) -> tuple:
    """(split_tok, n_split): cut each row's timeline into whole-chunk
    splits until the grid holds about four blocks per SM, since a decode
    step alone has only B * Hkv row tiles; windows that fill the card
    already run as one split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-gs // _ROWS) * h_kv * b
    chunks = -(-timeline // _CHUNK)
    n = max(1, min(-(-4 * sms // tiles), chunks))
    split_tok = -(-chunks // n) * _CHUNK
    return split_tok, -(-timeline // split_tok)


paged_decode = _PagedDecode()
KERNELS: List[_Kernel] = [paged_decode]


def build_all() -> Dict[str, float]:
    """Build and load every kernel library; returns {source: seconds}.
    One source so far: with a second, start one ``nvcc`` per source
    together."""
    out = {}
    for k in KERNELS:
        t0 = time.perf_counter()
        k.fn()
        out[k.source.name] = time.perf_counter() - t0
    return out
