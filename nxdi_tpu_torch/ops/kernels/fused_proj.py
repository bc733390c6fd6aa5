"""Fused projections: the QKV GEMM and the gate/up/down MLP, as CUDA kernels
(``csrc/qkv_matmul.cu`` and ``csrc/fused_mlp.cu`` on the tiled GEMM of
``csrc/gemm_kernel.cuh``) and their plain PyTorch versions.

Counterpart of ``nxdi_tpu/ops/kernels/fused_proj.py``:

- :func:`qkv_matmul` and :func:`qkv_matmul_stacked` replace the two QKV
  entries (``pl.pallas_call`` at fused_proj.py:405 and :327): x @ the fused
  interleaved QKV weight, f32 accumulation, x.dtype out; the bias is added
  outside the kernel, as in JAX. One CUDA kernel serves both: the stacked
  entry hands it the (L, H_in, T) weight and the layer index, and the kernel
  offsets its pointer.
- :func:`fused_mlp` and :func:`fused_mlp_stacked` replace the two MLP entries
  (``pl.pallas_call`` at :128 and :246): ``down(act(x @ gate) * (x @ up))``
  with g and u in f32, their product rounded to x.dtype (the TPU kernel's
  rounding point), the down product accumulated in f32, x.dtype out. The TPU
  kernel keeps a (rows, H) f32 accumulator in VMEM across a sequential walk
  over I tiles; a CUDA block cannot hold that (512 KB at 64 rows and H =
  2048) nor carry it across the grid, so one call is two device kernels: a
  dual GEMM that reads each x tile once for gate and up and writes the
  rounded (M, I) intermediate to a scratch the wrapper allocates, then the
  GEMM over (M, I) @ (I, H). The ``launches`` counter counts calls.

Each wrapper takes its plain version for tensors on the CPU only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nxdi_tpu_torch.ops.kernels import _build

KERNEL_ACTS = ("silu", "gelu", "gelu_pytorch_tanh", "gelu_new", "relu")
# activation codes of csrc/fused_mlp.cu
_ACT_CODES = {"silu": 0, "gelu": 1, "gelu_pytorch_tanh": 2, "gelu_new": 2, "relu": 3}


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return x * torch.sigmoid(x)
    if name in ("gelu_pytorch_tanh", "gelu_new"):
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    if name == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if name == "relu":
        return torch.clamp_min(x, 0.0)
    raise NotImplementedError(f"fused MLP kernel: unsupported activation {name!r}")


# ---------------------------------------------------------------------------
# Eligibility: the JAX rule accepts every shape; the CUDA kernel's own limits
# ---------------------------------------------------------------------------


def gemm_card_limits(k: int, n: int, dtype: torch.dtype):
    """What the CUDA GEMM needs beyond the JAX rule: rows of 16-byte chunks
    (the cp.async tile loads) and a supported dtype."""
    bad = []
    if k % 8 or n % 8:
        bad.append(f"GEMM widths ({k}, {n}) are not multiples of 8")
    if dtype not in _build.DTYPE_CODES:
        bad.append(f"dtype {dtype} is not float32 or bfloat16")
    return bad


def _check_operands(name, x, *ws):
    for t in (x,) + ws:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: operands must share one CUDA device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous with a 16-byte aligned base")
    bad = gemm_card_limits(x.shape[-1], ws[0].shape[-1], x.dtype)
    for w in ws[1:]:
        bad += gemm_card_limits(w.shape[-2], w.shape[-1], x.dtype)
    if bad:
        raise ValueError(f"{name}: " + "; ".join(dict.fromkeys(bad)))


# ---------------------------------------------------------------------------
# QKV
# ---------------------------------------------------------------------------


def qkv_matmul_plain(x, w, b=None):
    """Plain PyTorch version: f32 accumulation, x.dtype out, bias added in
    x.dtype afterwards."""
    out = (x.float() @ w.float()).to(x.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def _qkv_launch(x, w_s, layer, b):
    name = "qkv_matmul"
    M, K = x.shape
    N = w_s.shape[-1]
    if w_s.shape[-2] != K:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match w {tuple(w_s.shape)}")
    code = _build.dtype_code(x, name)
    _check_operands(name, x, w_s)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    layer_stride = K * N if w_s.dim() == 3 else 0
    err = _build.library().nxdi_qkv_matmul(
        code, x.data_ptr(), w_s.data_ptr(), out.data_ptr(), M, N, K, int(layer), layer_stride,
        _build.stream_ptr(x.device),
    )
    _build.check(err, name)
    qkv_matmul.launches += 1
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def qkv_matmul(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, H_in) @ w (H_in, T) (+ b (T,), added outside the kernel) ->
    (M, T) in x's dtype."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"qkv_matmul: x {tuple(x.shape)} and w {tuple(w.shape)} must be 2-D")
    _build.dtype_code(x, "qkv_matmul")
    if x.device.type == "cpu":
        return qkv_matmul_plain(x, w, b)
    return _qkv_launch(x, w, 0, b)


qkv_matmul.launches = 0


def qkv_matmul_stacked(
    x: torch.Tensor,  # (M, H_in)
    w_s: torch.Tensor,  # (L, H_in, T)
    layer_idx: int,
    b_s: Optional[torch.Tensor] = None,  # (L, T), added outside the kernel
) -> torch.Tensor:
    """The stacked entry: layer ``layer_idx`` of the (L, H_in, T) weight.
    Launches the same kernel as :func:`qkv_matmul` (at a pointer offset) and
    counts there."""
    li = int(layer_idx)
    if x.dim() != 2 or w_s.dim() != 3 or not 0 <= li < w_s.shape[0]:
        raise ValueError(f"qkv_matmul_stacked: x {tuple(x.shape)}, w {tuple(w_s.shape)}, "
                         f"layer {li}")
    b = None if b_s is None else b_s[li]
    _build.dtype_code(x, "qkv_matmul")
    if x.device.type == "cpu":
        return qkv_matmul_plain(x, w_s[li], b)
    return _qkv_launch(x, w_s, li, b)


# ---------------------------------------------------------------------------
# Fused MLP
# ---------------------------------------------------------------------------


def fused_mlp_plain(x, gate_w, up_w, down_w, act="silu"):
    """Plain PyTorch version: g = x @ gate and u = x @ up in f32, a =
    act(g) * u rounded to x.dtype, the down product accumulated in f32, x.dtype
    out."""
    xf = x.float()
    g = xf @ gate_w.float()
    u = xf @ up_w.float()
    a = (_act(g, act) * u).to(x.dtype)
    return (a.float() @ down_w.float()).to(x.dtype)


def _mlp_launch(x, gate_s, up_s, down_s, layer, act):
    name = "fused_mlp"
    M, H = x.shape
    I = gate_s.shape[-1]
    if (gate_s.shape[-2:] != (H, I) or up_s.shape != gate_s.shape
            or down_s.shape[-2:] != (I, H)):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} gate {tuple(gate_s.shape)} "
                         f"up {tuple(up_s.shape)} down {tuple(down_s.shape)}")
    code = _build.dtype_code(x, name)
    _check_operands(name, x, gate_s, up_s, down_s)
    inter = torch.empty((M, I), dtype=x.dtype, device=x.device)
    out = torch.empty((M, H), dtype=x.dtype, device=x.device)
    stacked = gate_s.dim() == 3
    err = _build.library().nxdi_fused_mlp(
        code, _ACT_CODES[act], x.data_ptr(), gate_s.data_ptr(), up_s.data_ptr(),
        down_s.data_ptr(), inter.data_ptr(), out.data_ptr(), M, H, I, int(layer),
        H * I if stacked else 0, _build.stream_ptr(x.device),
    )
    _build.check(err, name)
    fused_mlp.launches += 1
    return out


def _check_act(act):
    if act not in KERNEL_ACTS:
        raise NotImplementedError(f"fused MLP kernel: unsupported activation {act!r}")


def fused_mlp(
    x: torch.Tensor,  # (M, H)
    gate_w: torch.Tensor,  # (H, I)
    up_w: torch.Tensor,  # (H, I)
    down_w: torch.Tensor,  # (I, H)
    *,
    act: str = "silu",
) -> torch.Tensor:
    """``down(act(x @ gate) * (x @ up))`` -> (M, H) in x's dtype."""
    _check_act(act)
    _build.dtype_code(x, "fused_mlp")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, gate_w, up_w, down_w, act)
    return _mlp_launch(x, gate_w, up_w, down_w, 0, act)


fused_mlp.launches = 0


def fused_mlp_stacked(
    x: torch.Tensor,  # (M, H)
    gate_s: torch.Tensor,  # (L, H, I)
    up_s: torch.Tensor,  # (L, H, I)
    down_s: torch.Tensor,  # (L, I, H)
    layer_idx: int,
    *,
    act: str = "silu",
) -> torch.Tensor:
    """The stacked entry: layer ``layer_idx`` of the stacked weights. Launches
    the same kernels as :func:`fused_mlp` (at a pointer offset) and counts
    there."""
    _check_act(act)
    li = int(layer_idx)
    if gate_s.dim() != 3 or not 0 <= li < gate_s.shape[0]:
        raise ValueError(f"fused_mlp_stacked: gate {tuple(gate_s.shape)}, layer {li}")
    _build.dtype_code(x, "fused_mlp")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, gate_s[li], up_s[li], down_s[li], act)
    return _mlp_launch(x, gate_s, up_s, down_s, li, act)
