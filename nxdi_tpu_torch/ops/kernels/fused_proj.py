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
  over I tiles; a CUDA block cannot hold that (1 MB at 128 rows and H =
  2048) nor carry it across the grid, so one call is two GEMMs: a dual GEMM
  that reads each x tile once for gate and up and writes the rounded (M, I)
  intermediate to a scratch the wrapper allocates, then the GEMM over
  (M, I) @ (I, H). The ``launches`` counter counts calls.

Each GEMM of a bf16 call runs the body :func:`gemm_plan` picks for its M,
both on TMA and ``wgmma``: split-K weight streaming for up to 64 rows
(decode and the small mixed buckets, bound by the weight bytes), or the
two-warpgroup body for more (the packed steps, bound by operations), with K
split where the tiles alone would not fill the card; a split call's f32
partials go to a workspace the wrapper allocates and are summed in slice
order by a second kernel, so the output is the same bits on every call.
float32 runs one CUDA-core body.

Each wrapper takes its plain version for tensors on the CPU only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
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
# The plan of one GEMM on the card: which body, which tiles, how K is split
# ---------------------------------------------------------------------------

# body codes of csrc/gemm_kernel.cuh (GemmBody)
GEMM_BODIES = {"simt": 0, "stream": 1, "wgmma": 2}
STREAM_MAX_M = 64  # the weight-streaming body serves up to this many rows
# blocks per SM the streaming body's K split aims at (two fit on an SM; one
# each, with longer slices, streamed faster on an H100: scripts/bench_gemm_plans.py)
STREAM_BLOCKS_PER_SM = 1
GEMM_BK = 64  # K tile of both tensor-core bodies; a K slice is whole K tiles
# gemm_plan's model of the wgmma body, for choosing its tile width and K
# split: the operations one SM does per second on a tile, by the B tile's
# width, and the bytes per second of a split's partials (written, then read
# by the reduction). On an H100 (scripts/bench_gemm_plans.py) one wave of
# 128 x 128 tiles reached 50-52 % of the per-SM peak (QKV, M = 520) and one
# of 128 x 256 tiles 62 % (M = 1032; 70 % with half the SMs busy). With 52 %,
# 63 % and 2 TB/s the model picks the fastest plan of the script's --grid
# for 14 of the 15 GEMMs at 128 ... 1032 rows (the 15th within 3 %).
_WGMMA_SM_FLOPS = {128: 989e12 / 132 * 0.52, 256: 989e12 / 132 * 0.63}
_SPLIT_BYTES_PER_S = 2.0e12


@dataclass(frozen=True)
class GemmPlan:
    """One GEMM launch: ``body`` over a grid of ``m_tiles`` x ``n_tiles``
    output tiles of ``bm`` x ``bn``, each tile's K range cut into ``splits``
    slices of ``k_slice`` elements (whole ``bk`` tiles; only the last slice is
    ragged, at K's end). With ``splits`` > 1 the partials need
    ``workspace_bytes`` of f32."""

    body: str
    bm: int
    bn: int
    bk: int
    m_tiles: int
    n_tiles: int
    splits: int
    k_slice: int
    workspace_bytes: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    @property
    def args(self):
        """(body code, tile rows, tile columns, splits, K slice), as the C
        entry points take them."""
        return (GEMM_BODIES[self.body], self.bm, self.bn, self.splits, self.k_slice)


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, dual: bool, num_sms: int = 132,
              dtype: torch.dtype = torch.bfloat16) -> GemmPlan:
    """The body, tiles and K split for an (M, K) @ (K, N) GEMM on a card
    with ``num_sms`` SMs (``dual``: the MLP's gate/up pair, two weights).
    Output tiles of the dual pair are half as wide as its B tiles (gate and
    up columns share one accumulator). ``scripts/bench_gemm_plans.py``
    measures this plan against the others the kernels can run.

    - float32: the CUDA-core body, 64 x 64 tiles, no split.
    - bf16, M <= 64: the weight-streaming body (bound by the weight bytes):
      64-row tiles (rows past M zero), B tiles 128 columns wide, and K split
      into the fewest slices (of at least two K tiles) that give every SM
      ``STREAM_BLOCKS_PER_SM`` blocks.
    - bf16, M > 64: the wgmma body (bound by operations): 128-row tiles, B
      tiles 128 or 256 columns wide. The width and the split count (at most
      8, at least four K tiles a slice) minimise a model of the time: whole
      waves of one-slice tiles at the width's measured rate, plus the
      partials' write and read when K is split — so a split pays where the
      tiles fill the waves badly (the down product at 520 rows), and wide
      tiles where there are enough of them.

    The workspace holds splits x M x N f32 partials (twice that for the
    dual pair: g and u), or nothing without a split.
    """
    if dtype == torch.float32:
        return GemmPlan("simt", 64, 64, 16, -(-M // 64), -(-N // 64), 1, K, 0)
    k_tiles = -(-K // GEMM_BK)
    planes = 2 if dual else 1  # B weights per tile, and f32 partial planes
    if M <= STREAM_MAX_M:
        body, bm, bn = "stream", 64, 128 // planes
        m_tiles, n_tiles = -(-M // bm), -(-N // bn)
        tiles = max(1, m_tiles * n_tiles)
        want = STREAM_BLOCKS_PER_SM * num_sms
        slice_tiles = max(2, -(-k_tiles * tiles // want))
        while slice_tiles > 2 and -(-k_tiles // slice_tiles) * tiles < want:
            slice_tiles -= 1
        splits = -(-k_tiles // slice_tiles)
    else:
        body, bm = "wgmma", 128
        m_tiles = -(-M // bm)

        def model(choice):
            width, s = choice
            tiles = m_tiles * -(-N // width)
            t_tile = 2 * bm * width * planes * K / _WGMMA_SM_FLOPS[width * planes]
            reduce_s = 2 * s * M * N * 4 * planes / _SPLIT_BYTES_PER_S if s > 1 else 0.0
            return math.ceil(tiles * s / num_sms) * t_tile / s + reduce_s

        bn, splits = min(((w // planes, s) for w in _WGMMA_SM_FLOPS
                          for s in range(1, max(1, min(8, k_tiles // 4)) + 1)), key=model)
        n_tiles = -(-N // bn)
    slice_tiles = -(-k_tiles // splits)
    splits = -(-k_tiles // slice_tiles)
    ws = splits * M * N * 4 * (2 if dual else 1) if splits > 1 else 0
    return GemmPlan(body, bm, bn, GEMM_BK, m_tiles, n_tiles, splits, slice_tiles * GEMM_BK, ws)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(M, N, K, dual, x):
    return gemm_plan(M, N, K, dual, _num_sms(x.device.index or 0), x.dtype)


def _workspace(nbytes, device):
    """The split partials' f32 workspace (uninitialised: every partial the
    reduction reads is written first), or a null pointer."""
    if nbytes == 0:
        return None, 0
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    return ws, ws.data_ptr()


# ---------------------------------------------------------------------------
# Eligibility: the JAX rule accepts every shape; the CUDA kernel's own limits
# ---------------------------------------------------------------------------


def gemm_card_limits(k: int, n: int, dtype: torch.dtype):
    """What the CUDA GEMM needs beyond the JAX rule: rows of 16-byte chunks
    (the TMA tile loads) and a supported dtype."""
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
    plan = _plan(M, N, K, False, x)
    ws, ws_ptr = _workspace(plan.workspace_bytes, x.device)
    err = _build.library().nxdi_qkv_matmul(
        code, x.data_ptr(), w_s.data_ptr(), out.data_ptr(), M, N, K, int(layer), layer_stride,
        *plan.args, ws_ptr, _build.stream_ptr(x.device),
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
    gu, dn = _plan(M, I, H, True, x), _plan(M, H, I, False, x)
    ws, ws_ptr = _workspace(max(gu.workspace_bytes, dn.workspace_bytes), x.device)
    err = _build.library().nxdi_fused_mlp(
        code, _ACT_CODES[act], x.data_ptr(), gate_s.data_ptr(), up_s.data_ptr(),
        down_s.data_ptr(), inter.data_ptr(), out.data_ptr(), M, H, I, int(layer),
        H * I if stacked else 0, *gu.args, *dn.args, ws_ptr, _build.stream_ptr(x.device),
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
