"""Build and load the hand-written CUDA kernels (``nxdi_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use — one
``nvcc -c`` per source, all started together, then one link — into a shared
library with a plain C interface, loaded with ``ctypes``. The library lives
under ``build/nxdi_tpu_torch/`` at the repository root, keyed on a hash of
the sources, so an edit rebuilds and an unchanged tree reuses the build.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nxdi_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the one-byte KV stores the paged, ragged and commit kernels take (codes
# shared with csrc/common.cuh)
STORE_CODES = {torch.float8_e4m3fn: 2, torch.float8_e5m2: 3, torch.int8: 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point (csrc/*.cu); each returns a cudaError_t
SIGNATURES = {
    "nxdi_flash_prefill": [_I, _I, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_LL] * 12
    + [_F, _I, _I, _P],
    # ... q_pos, kv_start, the cache lines and their count, ..., the kv split
    # (chunk length, chunks) and the partials' scratch; window, chunk and the
    # ring's slots before the split
    "nxdi_flash_decode_fused": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 6
    + [_LL] * 9 + [_F, _I, _I, _I, _I, _I, _P, _P],
    "nxdi_kv_commit_rows": [_P, _P, _P, _P, _P, _P] + [_I] * 6 + [_LL, _LL, _P],
    # blocks, threads, stream: an empty kernel (a launch's floor)
    "nxdi_empty_launch": [_I, _I, _P],
    "nxdi_flash_decode_window": [_I, _P, _P, _P, _P, _P, _P] + [_I] * 5 + [_LL] * 7
    + [_F, _I, _I, _I, _I, _I, _P, _P],
    # q's dtype, the pool's store dtype, ...
    "nxdi_paged_decode": [_I, _I, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_LL] * 4
    + [_F, _F, _I, _I, _P, _P],
    # dtype, store dtype, body (flash_attention.PREFILL_BODIES), ..., pool slots, ...
    "nxdi_paged_prefill": [_I, _I, _I, _P, _P, _P, _P, _P, _P] + [_I] * 8 + [_LL] * 6
    + [_F, _F, _P],
    # ... + the device work list and its host counts (direct tiles, items,
    # partial slots, tokens to combine, wgmma items), whether it is split
    # (its direct tiles hold one row each), then the partials' scratch, ...,
    # the pool's slots
    "nxdi_ragged_paged": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_P] + [_I] * 8
    + [_LL] * 4 + [_F, _F, _P],
    # ... + the GEMM plan (body, tile rows and columns, splits, K slice;
    # fused_proj.GemmPlan.args), twice for the MLP (gate/up, then down), the
    # split-K workspace, then the stream
    "nxdi_qkv_matmul": [_I, _P, _P, _P, _I, _I, _I, _I, _LL] + [_I] * 5 + [_P, _P],
    # the device loop's window graph (loop_graph.cu): body graph, window, t,
    # cap, done, rows, pinned host state, the exec out-pointer; then launch
    # and destroy
    "nxdi_loop_window_build": [_P, _I, _P, _I, _P, _I, _P, _P],
    "nxdi_loop_window_launch": [_P, _P],
    "nxdi_loop_window_destroy": [_P],
    "nxdi_fused_mlp": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL] + [_I] * 10
    + [_P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. Raises with the compiler's output on failure."""
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / "libnxdi_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    common = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", str(CSRC)]
    if verbose:
        common += ["-Xptxas", "-v"]
    procs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *common, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{text}")
        elif verbose and text.strip():
            print(f"[nvcc {src.name}]\n{text}", flush=True)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    tmp = out_dir / f"libnxdi_kernels.{os.getpid()}.so"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError("CUDA kernel link failed:\n" + res.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({_error_string(err)})")


def _error_string(err: int) -> str:
    try:
        rt = ctypes.CDLL("libcudart.so")
    except OSError:
        return "cudaError_t"
    rt.cudaGetErrorString.restype = ctypes.c_char_p
    rt.cudaGetErrorString.argtypes = [ctypes.c_int]
    return rt.cudaGetErrorString(err).decode()


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``. The library links its own CUDA
    runtime, whose current device is the first card, so tensors must live
    there."""
    if device.index not in (None, 0):
        raise NotImplementedError(f"the CUDA kernels launch on cuda:0 only, got {device}")
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} is not supported (float32, bfloat16)")
    return DTYPE_CODES[t.dtype]


def store_code(kv: torch.Tensor, q: torch.Tensor, name: str) -> int:
    """The code of a KV store: q's dtype, or one byte (float8_e4m3fn,
    float8_e5m2, int8)."""
    if kv.dtype == q.dtype:
        return dtype_code(q, name)
    if kv.dtype not in STORE_CODES:
        raise TypeError(f"{name}: KV store dtype {kv.dtype} is neither q's ({q.dtype}) nor "
                        "a one-byte store (float8_e4m3fn, float8_e5m2, int8)")
    return STORE_CODES[kv.dtype]
