"""Weight quantization — int8 / fp8 weights, MXFP4 blocks, int8 activations,
and the parameter-tree transforms (counterpart of
``nxdi_tpu/ops/quantization.py``, same keys, shapes and arithmetic).

Conventions (the JAX package's):

- Weights live in ``(in, out)`` layout; per-channel scales reduce over the
  ``in`` axis with keepdims, so dequantization is the broadcast
  ``qw.to(dt) * scale`` at any rank (layer-stacked ``(L, in, out)`` too).
- A "linear param dict" is any dict holding ``"w"``. Quantization replaces
  it with ``{"qw", "scale", **rest}`` (or ``{"qw4", "scale"}`` for MXFP4);
  ``models/base._linear`` consumes either form through
  :func:`quantized_linear`.
- The quantized values are made in float32 with exactly rounded operations
  (on the weights' device; MXFP4 on the host with numpy), so both packages
  store the same bits; the fp8 leaves are ``torch.float8_e4m3fn`` /
  ``torch.float8_e5m2`` tensors.

The JAX package leaves the dequantizing product to XLA, which fuses the
upcast into the matmul's operand read. Eager torch has no such fusion: the
weight-only path here writes a compute-dtype copy of each weight per call
(``qw.to(x.dtype)``), then multiplies. That copy is what the path costs
over an unquantized product; ``PERF.md`` records it. The int8 activation
paths compute the int8 x int8 -> int32 product exactly (:func:`int8_matmul`);
no path switches to a float product silently.

``quantize_param_specs`` and ``quantize_shape_struct`` (the JAX package's
sharding and AOT structs) are not ported: they wait for the parallel
layers (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import hashlib
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# quant dtype name -> (torch dtype, qmax)
QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "f8e4m3": (torch.float8_e4m3fn, 448.0),
    "f8e5m2": (torch.float8_e5m2, 57344.0),
}

PER_TENSOR = "per_tensor_symmetric"
PER_CHANNEL = "per_channel_symmetric"
MXFP4 = "mxfp4"  # OCP microscaling fp4: E2M1 values, power-of-2 block scales

MXFP4_BLOCK = 32
# E2M1 representable magnitudes; stored as value*2 in int8 so the grid is
# integer-exact ({0,1,2,3,4,6,8,12} with signs)
_E2M1_GRID = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32)

# Never quantized whatever the config says (routing and norms stay full
# precision; biased norms are {"w", "b"} dicts that must not pass for linears)
DEFAULT_MODULES_TO_NOT_CONVERT = (
    "router",
    "shared_expert_gate",
    "input_layernorm",
    "post_attention_layernorm",
    "pre_feedforward_layernorm",
    "post_feedforward_layernorm",
    "norm",
    "layer_norm",
    "pre_layernorm",
    "ln1",
    "ln2",
    "self_attn_layer_norm",
    "encoder_attn_layer_norm",
    "final_layer_norm",
)


def _f32(w) -> np.ndarray:
    """A weight (tensor of any float dtype, or array) as float32 numpy."""
    if isinstance(w, torch.Tensor):
        return w.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(w, dtype=np.float32)


def quantize_mxfp4(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """OCP MXFP4: 32-element blocks along the ``in`` axis share a
    power-of-two scale; elements quantize to the E2M1 grid.

    Returns ``(qw4, scale)``: qw4 int8 of shape (..., in/32, 32, out) holding
    2x the fp4 value (integer-exact), scale float32 (..., in/32, 1, out) with
    the 0.5 folded in, so ``qw4 * scale`` dequantizes by broadcast."""
    w32 = _f32(w)
    fin = w32.shape[-2]
    if fin % MXFP4_BLOCK:
        raise ValueError(f"mxfp4 needs the in dim ({fin}) divisible by {MXFP4_BLOCK}")
    nb = fin // MXFP4_BLOCK
    blocks = w32.reshape(*w32.shape[:-2], nb, MXFP4_BLOCK, w32.shape[-1])
    amax = np.max(np.abs(blocks), axis=-2, keepdims=True)
    # power-of-two scale: smallest 2^e with amax/2^e <= 6 (the E2M1 max)
    e = np.ceil(np.log2(np.maximum(amax, 1e-30) / _E2M1_GRID[-1]))
    scale = np.exp2(e).astype(np.float32)
    t = blocks / scale
    mids = (_E2M1_GRID[:-1] + _E2M1_GRID[1:]) / 2  # nearest-grid thresholds
    idx = np.searchsorted(mids, np.abs(t), side="right")
    q = np.sign(t) * _E2M1_GRID[idx] * 2.0  # store value*2
    return (torch.from_numpy(q.astype(np.int8)),
            torch.from_numpy((scale * 0.5).astype(np.float32)))


def quantize_array(w, quant_dtype: str = "int8",
                   scheme: str = PER_CHANNEL) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization of an (in, out)-layout weight (any rank >= 2),
    on the weight's device. Returns ``(qw, scale)``, ``scale`` float32 with
    keepdims over the reduced axes, so that ``qw * scale`` dequantizes by
    broadcast. Every step is an exactly rounded float32 operation (divisions
    by tensors: torch divides by a scalar through its reciprocal), so any
    device gives the JAX package's numpy bits."""
    if quant_dtype == MXFP4 or scheme == MXFP4:
        return quantize_mxfp4(w)
    dt, qmax = QUANT_DTYPES[quant_dtype]
    w32 = torch.as_tensor(w).detach().to(torch.float32)
    if scheme == PER_TENSOR:
        # one scale per stacked (in, out) matrix
        amax = w32.abs().amax(dim=(-2, -1), keepdim=True)
    elif scheme == PER_CHANNEL:
        amax = w32.abs().amax(dim=-2, keepdim=True)
    else:
        raise ValueError(f"unknown quantization scheme {scheme!r}")
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, qmax)
    q = w32 / scale
    if quant_dtype == "int8":
        qw = torch.round(q).clamp(-127, 127).to(dt)
    else:
        # in range after the clamp, where torch's and the JAX package's float32 ->
        # fp8 conversions both round to nearest even
        qw = q.clamp(-qmax, qmax).to(dt)
    return qw, scale


def dequantize_array(qw, scale, dtype=torch.float32) -> torch.Tensor:
    return (torch.as_tensor(qw).to(torch.float32) * torch.as_tensor(scale)).to(dtype)


def is_quantized(p: Dict[str, Any]) -> bool:
    return isinstance(p, dict) and ("qw" in p or "qw4" in p)


def materialize_weight(p: Dict[str, Any], dtype) -> torch.Tensor:
    """The (dequantized) weight in ``dtype``: MXFP4 blocks flattened back to
    (in, out), or ``qw * scale``, or ``w``."""
    if "qw4" in p:
        w = p["qw4"].to(dtype) * p["scale"].to(dtype)
        return w.reshape(*w.shape[:-3], w.shape[-3] * w.shape[-2], w.shape[-1])
    if "qw" in p:
        return p["qw"].to(dtype) * p["scale"].to(dtype)
    return p["w"].to(dtype)


# torch._int_mm's shape rule on the card: its M above 16, M, K and N
# multiples of 8 (and b column-major, see int8_matmul)
_INT_MM_MIN_M = 17
_INT_MM_ALIGN = 8


def int_mm_padding(M: int, K: int, N: int) -> Tuple[int, int, int]:
    """The padded (M, K, N) of an int8 product on the card: M raised to at
    least 17 and every dimension to a multiple of 8. The padded rows and
    columns are zeros, so they add 0 to every int32 sum and are cut off."""
    up = lambda n: -(-n // _INT_MM_ALIGN) * _INT_MM_ALIGN  # noqa: E731
    return up(max(M, _INT_MM_MIN_M)), up(K), up(N)


def int8_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The exact int8 x int8 -> int32 product of (..., K) by (K, N), as
    ``jax.lax.dot_general(..., preferred_element_type=int32)`` gives it. On
    the CPU an int32 matmul; on the card ``torch._int_mm`` (the JAX package
    computes this product outside its kernels too) on operands padded with
    zeros to its shape rule (:func:`int_mm_padding`)."""
    lead, K = qx.shape[:-1], qx.shape[-1]
    N = qw.shape[-1]
    a = qx.reshape(-1, K)
    if qx.device.type != "cuda":
        y = a.to(torch.int32) @ qw.to(torch.int32)
        return y.reshape(*lead, N)
    M = a.shape[0]
    Mp, Kp, Np = int_mm_padding(M, K, N)
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    b = qw
    if (Kp, Np) != (K, N):
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    # cuBLASLt's int8 product takes row-major a and column-major b
    y = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return y[:M, :N].reshape(*lead, N)


def quantized_linear(
    x: torch.Tensor,
    p: Dict[str, Any],
    act_quant: Optional[str] = None,
    clamp_bound: Optional[float] = None,
) -> torch.Tensor:
    """``x @ W`` over a quantized param dict ``{"qw", "scale"[, "b"]}`` (or
    ``{"qw4", "scale"}``).

    Weight-only: upcast, multiply, scale the output columns.
    ``act_quant="dynamic"`` with an int8 weight quantizes the activations per
    token (symmetric, amax / 127) and takes the exact int32 product;
    ``"static"`` uses the calibrated per-tensor ``input_scale`` instead."""
    if "qw4" in p:  # mxfp4: dequantize on read, weight-only
        y = x @ materialize_weight(p, x.dtype)
        if "b" in p:
            y = y + p["b"]
        return y
    qw, scale = p["qw"], p["scale"]
    if act_quant == "dynamic" and qw.dtype == torch.int8:
        if clamp_bound is not None:
            x = x.clamp(-clamp_bound, clamp_bound)
        x_amax = x.abs().amax(dim=-1, keepdim=True)
        if _CALIB is not None:
            # calibration pass: record the largest activation magnitude this
            # linear has seen, keyed by the weight's content
            key = _weight_fingerprint(qw)
            _CALIB[key] = max(_CALIB.get(key, 0.0), float(x_amax.max()))
        x_amax = torch.clamp_min(x_amax.to(torch.float32), 1e-12)
        x_scale = x_amax / torch.full_like(x_amax, 127.0)  # a true division (see quantize_array)
        qx = torch.clamp(torch.round(x.to(torch.float32) / x_scale), -127, 127).to(torch.int8)
        y = int8_matmul(qx, qw)
        y = y.to(torch.float32) * x_scale * scale.squeeze(-2)
        y = y.to(x.dtype)
    elif act_quant == "static" and qw.dtype == torch.int8:
        if clamp_bound is not None:
            x = x.clamp(-clamp_bound, clamp_bound)
        in_s = p["input_scale"].to(torch.float32)
        qx = torch.clamp(torch.round(x.to(torch.float32) / in_s), -127, 127).to(torch.int8)
        y = int8_matmul(qx, qw)
        y = y.to(torch.float32) * in_s * scale.squeeze(-2)
        y = y.to(x.dtype)
    else:
        y = x @ qw.to(x.dtype)
        y = y * scale.squeeze(-2).to(x.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Parameter-tree transforms
# ---------------------------------------------------------------------------

def _should_quantize(path: Tuple[str, ...], skip: Optional[list]) -> bool:
    """Module-name filter (``modules_to_not_convert``): ``skip`` entries match
    the last path component ("o_proj") or a dotted path suffix on component
    boundaries ("attn.o_proj", not "self_attn.o_proj"). The defaults in
    :data:`DEFAULT_MODULES_TO_NOT_CONVERT` always apply."""
    skip = list(DEFAULT_MODULES_TO_NOT_CONVERT) + list(skip or [])
    dotted = ".".join(str(s) for s in path)
    for name in skip:
        if path and str(path[-1]) == name:
            return False
        if dotted == name or dotted.endswith("." + name):
            return False
    return True


def _walk(tree: Any, path: Tuple[str, ...], fn):
    if isinstance(tree, dict):
        if "w" in tree:
            out = fn(tree, path)
            if out is not None:
                return out
        return {k: _walk(v, path + (k,), fn) for k, v in tree.items()}
    return tree


def quantize_params(
    params: Dict[str, Any],
    quant_dtype: str = "int8",
    scheme: str = PER_CHANNEL,
    modules_to_not_convert: Optional[list] = None,
    static_input_scales: bool = False,
) -> Dict[str, Any]:
    """Quantize every linear param dict (``{"w": ...}``) of a params tree, on
    its device; biases and norms pass through. ``static_input_scales`` seeds an
    identity ``input_scale`` of 1.0 per quantized linear (one per stacked
    layer): run :func:`calibrate_input_scales` before serving with it."""

    def fn(d, path):
        if not _should_quantize(path, modules_to_not_convert):
            return None
        qw, scale = quantize_array(d["w"], quant_dtype, scheme)
        out = {k: v for k, v in d.items() if k != "w"}
        if quant_dtype == MXFP4 or scheme == MXFP4:
            out.update(qw4=qw, scale=scale)
        else:
            out.update(qw=qw, scale=scale)
            if static_input_scales:
                out["input_scale"] = torch.ones(tuple(d["w"].shape[:-2]), dtype=torch.float32,
                                                device=d["w"].device)
        return out

    return _walk(params, (), fn)


# ---------------------------------------------------------------------------
# Static activation calibration
# ---------------------------------------------------------------------------

_CALIB: Optional[Dict[Any, float]] = None


def _weight_fingerprint(qw) -> Tuple:
    """Shape + full-content hash of a quantized weight (or one layer of a
    stacked one): two linears with the same shape never share a bucket."""
    t = torch.as_tensor(qw).detach().to("cpu").contiguous()
    raw = t.view(torch.uint8).numpy().tobytes() if t.element_size() == 1 else t.numpy().tobytes()
    return (tuple(t.shape), str(t.dtype), hashlib.sha1(raw).digest())


@contextmanager
def activation_calibration():
    """Collect per-linear activation amax during DYNAMIC-quant forwards
    (eager torch makes the amax concrete). Yields the collector dict keyed
    by weight fingerprint."""
    global _CALIB
    prev, _CALIB = _CALIB, {}
    try:
        yield _CALIB
    finally:
        _CALIB = prev


def attach_input_scales(params: Dict[str, Any], amax_by_fp: Dict[Any, float]) -> Dict[str, Any]:
    """Write calibrated ``input_scale = amax / 127`` into every quantized
    linear the calibration traffic touched; a layer-stacked weight gets a
    per-layer (L,) vector. Untouched linears keep their scale, or get the
    identity placeholder."""

    def scale_of(amax: float) -> float:
        return float(np.float32(max(amax, 1e-12) / 127.0))

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        if "qw" in tree:
            qw = tree["qw"]
            whole = _weight_fingerprint(qw)
            if whole in amax_by_fp:
                return {**tree, "input_scale": torch.tensor(scale_of(amax_by_fp[whole]),
                                                            dtype=torch.float32)}
            if qw.dim() >= 3:
                keys = [_weight_fingerprint(qw[i]) for i in range(qw.shape[0])]
                if any(k in amax_by_fp for k in keys):
                    cur = torch.as_tensor(tree.get("input_scale", torch.tensor(1.0)),
                                          dtype=torch.float32).to("cpu").expand(qw.shape[0])
                    scales = [scale_of(amax_by_fp[k]) if k in amax_by_fp else float(cur[i])
                              for i, k in enumerate(keys)]
                    return {**tree, "input_scale": torch.tensor(scales, dtype=torch.float32)}
            if "input_scale" not in tree:
                return {**tree,
                        "input_scale": torch.ones(tuple(qw.shape[:-2]), dtype=torch.float32)}
            return tree
        return {k: walk(v) for k, v in tree.items()}

    return walk(params)


def calibrate_input_scales(forward_fn, params, sample_batches):
    """Offline static-activation calibration: run ``forward_fn(params, batch)``
    for each sample batch with the collector active (its linears must go
    through :func:`quantized_linear` with ``act_quant="dynamic"``), then
    return params with calibrated ``input_scale`` entries."""
    with torch.no_grad(), activation_calibration() as rec:
        for batch in sample_batches:
            forward_fn(params, batch)
    return attach_input_scales(params, rec)


def calibrate_app_input_scales(app, sample_prompts):
    """Application-level static-activation calibration: run context
    encodings of the sample prompts EAGERLY (no CUDA graph) on an app built
    with ``activation_quantization_type="dynamic"``, record each linear's
    input amax, and return the app's params with calibrated
    ``input_scale`` entries (serve them with ``"static"``)."""
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING

    w = app.models[TAG_CONTEXT_ENCODING]
    saved = w.graphs
    w.graphs = False
    try:
        with torch.no_grad(), activation_calibration() as rec:
            for ids in sample_prompts:
                ids = np.asarray(ids)
                pos = np.tile(np.arange(ids.shape[1], dtype=np.int32), (ids.shape[0], 1))
                app.forward(ids, pos)
    finally:
        w.graphs = saved
    return attach_input_scales(app.params, rec)


def validate_quantized_params(params: Dict[str, Any], tpu_config) -> None:
    """Check a loaded pre-quantized artifact against the configured scheme:
    the qw dtype must match ``quantization_dtype`` and the scale shapes
    ``quantization_type``."""
    want_mx = tpu_config.quantization_dtype == MXFP4
    want_dt = None if want_mx else QUANT_DTYPES[tpu_config.quantization_dtype][0]
    scheme = tpu_config.quantization_type
    problems = []

    def visit(tree, path):
        if not isinstance(tree, dict):
            return
        if "qw4" in tree:
            name = ".".join(path)
            if not want_mx:
                problems.append(
                    f"{name}: artifact holds mxfp4 (qw4) but configured "
                    f"quantization_dtype={tpu_config.quantization_dtype}"
                )
                return
            q4 = tree["qw4"]
            if q4.dtype != torch.int8:
                problems.append(f"{name}: qw4 dtype {q4.dtype} != int8")
            if q4.dim() < 3 or q4.shape[-2] != MXFP4_BLOCK:
                problems.append(
                    f"{name}: qw4 shape {tuple(q4.shape)} is not the "
                    f"(..., nb, {MXFP4_BLOCK}, out) block layout"
                )
            elif "scale" not in tree:
                problems.append(f"{name}: missing mxfp4 scale")
            elif tuple(tree["scale"].shape) != tuple(q4.shape[:-2]) + (1, q4.shape[-1]):
                problems.append(
                    f"{name}: scale shape {tuple(tree['scale'].shape)} != "
                    f"{tuple(q4.shape[:-2]) + (1, q4.shape[-1])}"
                )
            return
        if "qw" in tree:
            if want_mx:
                problems.append(
                    ".".join(path) + ": artifact holds qw but configured "
                    "quantization_dtype=mxfp4 expects qw4 block layout"
                )
                return
            name = ".".join(path)
            qw = tree["qw"]
            if qw.dtype != want_dt:
                problems.append(
                    f"{name}: qw dtype {qw.dtype} != configured "
                    f"quantization_dtype={tpu_config.quantization_dtype}"
                )
            want = (tuple(qw.shape[:-2]) + (1, 1) if scheme == PER_TENSOR
                    else tuple(qw.shape[:-2]) + (1, qw.shape[-1]))
            if tuple(tree["scale"].shape) != want:
                problems.append(
                    f"{name}: scale shape {tuple(tree['scale'].shape)} != {want} "
                    f"expected for quantization_type={scheme}"
                )
            return
        for k, v in tree.items():
            visit(v, path + (k,))

    visit(params, ())
    if problems:
        raise ValueError(
            "quantized_checkpoints_path artifact does not match the configured "
            "quantization scheme:\n  " + "\n  ".join(problems[:8])
        )


def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted-key flat dict (the safetensors layout of a quantized
    checkpoint)."""
    flat: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_params(v, key + "."))
        else:
            flat[key] = torch.as_tensor(v)
    return flat


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out
