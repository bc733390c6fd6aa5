"""The port's weight quantization (``nxdi_tpu_torch/ops/quantization.py``)
held against the JAX package's (``nxdi_tpu/ops/quantization.py``): the same
numpy weights through both.

- ``quantize_array`` for every dtype x scheme and MXFP4: bit-equal (fp8
  compared as ``uint8`` views).
- ``quantized_linear``: the int8 x int8 -> int32 product exactly equal to
  ``jax.lax.dot_general``'s; the linear's outputs within 1e-5 (float32:
  the two packages' float products sum in different orders).
- parameter trees: ``quantize_params`` gives the same tree and skip set,
  ``flatten_params`` / ``unflatten_params`` round-trip, ``from_jax_params``
  carries quantized leaves bit for bit, the checkpoint validation refuses
  what the JAX package refuses.
- end to end on the tiny random llama: greedy ``generate()`` tokens
  identical to the JAX package's with int8 (per-tensor, per-channel, dynamic
  activations) and fp8 weights, and a saved quantized checkpoint reloads to
  the same tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.ops import quantization as jq
from nxdi_tpu_torch.config import TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.ops import quantization as tq
from test_torch_slice import fresh_jax_compiles, jax_app, port_app

LINEAR_TOL = 1e-5
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)
DTYPES = ("int8", "f8e4m3", "f8e5m2")
SCHEMES = (tq.PER_TENSOR, tq.PER_CHANNEL)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _bits(x) -> np.ndarray:
    """The stored bits of a quantized leaf from either package."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.element_size() == 1 else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _weights(seed, shape=(3, 64, 48)):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    w[..., 0, 0] = 0.9  # an outlier, so per-tensor and per-channel scales differ
    return w


@pytest.mark.parametrize("quant_dtype", DTYPES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_array_bit_equal(quant_dtype, scheme):
    w = _weights(0)
    jqw, jscale = jq.quantize_array(w, quant_dtype, scheme)
    tqw, tscale = tq.quantize_array(w, quant_dtype, scheme)
    assert tqw.dtype == tq.QUANT_DTYPES[quant_dtype][0]
    np.testing.assert_array_equal(_bits(tqw), _bits(jqw))
    np.testing.assert_array_equal(tscale.numpy(), jscale)
    # and from a bf16 torch weight (the port's params), the same bits
    wb = torch.from_numpy(w).to(torch.bfloat16)
    jqb, _ = jq.quantize_array(wb.float().numpy(), quant_dtype, scheme)
    np.testing.assert_array_equal(_bits(tq.quantize_array(wb, quant_dtype, scheme)[0]),
                                  _bits(jqb))


def test_quantize_mxfp4_bit_equal():
    w = _weights(1, (2, 64, 24))
    w[0, :32, 0] = 0.0  # an all-zero block
    jqw, jscale = jq.quantize_array(w, "mxfp4")
    tqw, tscale = tq.quantize_array(w, "mxfp4")
    np.testing.assert_array_equal(tqw.numpy(), jqw)
    np.testing.assert_array_equal(tscale.numpy(), jscale)
    np.testing.assert_array_equal(tq.materialize_weight({"qw4": tqw, "scale": tscale},
                                                        torch.float32).numpy(),
                                  np.asarray(jq.materialize_weight(
                                      {"qw4": jnp.asarray(jqw), "scale": jnp.asarray(jscale)},
                                      jnp.float32)))
    with pytest.raises(ValueError, match="divisible by 32"):
        tq.quantize_mxfp4(np.zeros((48, 8), np.float32))


def test_int8_product_is_exact():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, size=(2, 5, 64)).astype(np.int8)
    b = rng.integers(-127, 128, size=(64, 40)).astype(np.int8)
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K,N,want", [(1, 64, 48, (24, 64, 48)), (17, 60, 8, (24, 64, 8)),
                                        (520, 2048, 3072, (520, 2048, 3072))])
def test_int_mm_padding_rule(M, K, N, want):
    """The card's ``torch._int_mm`` takes M above 16 and every dimension a
    multiple of 8: the padding always meets that and never shrinks."""
    got = tq.int_mm_padding(M, K, N)
    assert got == want
    assert got[0] > 16 and all(d % 8 == 0 for d in got)


@pytest.mark.parametrize("case", ["int8", "f8e4m3", "mxfp4", "dynamic", "static", "bias"])
def test_quantized_linear_matches_jax(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = _weights(4, (64, 40))
    quant_dtype = {"f8e4m3": "f8e4m3", "mxfp4": "mxfp4"}.get(case, "int8")
    act = case if case in ("dynamic", "static") else None
    jqw, jscale = jq.quantize_array(w, quant_dtype, tq.PER_CHANNEL)
    tqw, tscale = tq.quantize_array(w, quant_dtype, tq.PER_CHANNEL)
    key = "qw4" if case == "mxfp4" else "qw"
    jp, tp = {key: jnp.asarray(jqw), "scale": jnp.asarray(jscale)}, {key: tqw, "scale": tscale}
    if case == "static":
        jp["input_scale"] = jnp.float32(0.02)
        tp["input_scale"] = torch.tensor(0.02)
    if case == "bias":
        b = rng.standard_normal(40).astype(np.float32)
        jp["b"], tp["b"] = jnp.asarray(b), torch.from_numpy(b)
    want = jq.quantized_linear(jnp.asarray(x), jp, act_quant=act, clamp_bound=3.0)
    got = tq.quantized_linear(torch.from_numpy(x), tp, act_quant=act, clamp_bound=3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LINEAR_TOL, rtol=0)


def _tree(seed):
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    return {
        "embed_tokens": w(16, 64),
        "norm": w(64),
        "layers": {
            "input_layernorm": w(2, 64),
            "attn": {"q_proj": {"w": w(2, 64, 64), "b": w(2, 64)}, "o_proj": {"w": w(2, 64, 64)}},
            "mlp": {"gate_proj": {"w": w(2, 64, 128)}, "down_proj": {"w": w(2, 128, 64)}},
        },
        "router": {"w": w(64, 4)},
    }


def _assert_same_tree(port, ref):
    assert port.keys() == ref.keys()
    for k, v in port.items():
        if isinstance(v, dict):
            _assert_same_tree(v, ref[k])
        else:
            r = ref[k]
            one_byte = (r.element_size() if isinstance(r, torch.Tensor)
                        else np.asarray(r).dtype.itemsize) == 1
            if one_byte:
                np.testing.assert_array_equal(_bits(v), _bits(r))
            else:
                np.testing.assert_array_equal(torch.as_tensor(v).float().numpy(),
                                              np.asarray(r, np.float32))


@pytest.mark.parametrize("quant_dtype,static", [("int8", True), ("f8e5m2", False),
                                                ("mxfp4", False)])
def test_quantize_params_tree_and_skip(quant_dtype, static):
    tree = _tree(5)
    skip = ["o_proj"]
    ref = jq.quantize_params(tree, quant_dtype, tq.PER_CHANNEL, skip, static_input_scales=static)
    port_in = {k: v for k, v in tree.items()}
    got = tq.quantize_params(from_jax_params(port_in), quant_dtype, tq.PER_CHANNEL, skip,
                             static_input_scales=static)
    _assert_same_tree(got, ref)
    assert "w" in got["layers"]["attn"]["o_proj"] and "w" in got["router"]  # skipped
    assert tq.is_quantized(got["layers"]["mlp"]["gate_proj"])
    for path in (("attn", "o_proj"), ("self_attn", "o_proj")):
        assert tq._should_quantize(path, ["attn.o_proj"]) == jq._should_quantize(
            path, ["attn.o_proj"])


def test_flatten_unflatten_and_from_jax_params():
    ref = jq.quantize_params(_tree(6), "f8e4m3", tq.PER_TENSOR)
    carried = from_jax_params(ref)  # fp8 leaves move as their bits
    assert carried["layers"]["attn"]["q_proj"]["qw"].dtype == torch.float8_e4m3fn
    _assert_same_tree(carried, ref)
    flat = tq.flatten_params(carried)
    assert set(flat) == set(jq.flatten_params(ref))
    _assert_same_tree(tq.unflatten_params(flat), ref)


def test_validate_quantized_params_refuses_like_jax():
    for cfg_kw, tree_dtype, scheme in (({"quantization_type": tq.PER_TENSOR}, "int8",
                                        tq.PER_CHANNEL),
                                       ({"quantization_dtype": "f8e4m3"}, "int8", tq.PER_TENSOR),
                                       ({"quantization_dtype": "mxfp4"}, "int8", tq.PER_TENSOR)):
        jtree = jq.quantize_params(_tree(7), tree_dtype, scheme)
        kw = dict(quantized=True, **cfg_kw)
        with pytest.raises(ValueError) as jerr:
            jq.validate_quantized_params(jtree, TpuConfig(**kw))
        with pytest.raises(ValueError) as terr:
            tq.validate_quantized_params(from_jax_params(jtree), TorchConfig(**kw))
        first = lambda e: str(e.value).split("\n")[1].split(":")[0]  # noqa: E731
        assert first(terr) == first(jerr)
    tq.validate_quantized_params(tq.quantize_params(from_jax_params(_tree(7)), "int8",
                                                    tq.PER_TENSOR),
                                 TorchConfig(quantized=True))


def test_config_rules_match_jax():
    for kw, msg in (
        (dict(activation_quantization_type="dynamic"), "requires quantized=True"),
        (dict(quantized=True, activation_quantization_type="bogus"),
         "activation_quantization_type"),
        (dict(quantized=True, mlp_kernel_enabled=True),
         "mlp_kernel_enabled composes with full-precision weights only"),
    ):
        with pytest.raises(ValueError, match=msg):
            TpuConfig(**kw)
        with pytest.raises(ValueError, match=msg):
            TorchConfig(**kw)
    tc = TorchConfig(quantized=True, activation_quantization_type="DYNAMIC")
    assert tc.activation_quantization_type == "dynamic"
    assert TorchConfig.from_dict(tc.to_dict()).activation_quantization_type == "dynamic"


def _generate_both(hf_model, hf_cfg, n=8, prompt=PROMPT, **kw):
    japp = jax_app(hf_model, hf_cfg, **kw)
    tapp = port_app(hf_model, hf_cfg, **kw)
    want = JaxAdapter(japp).generate(prompt, max_new_tokens=n)
    got = HuggingFaceGenerationAdapter(tapp).generate(prompt, max_new_tokens=n)
    return np.asarray(got), np.asarray(want), japp, tapp


@pytest.mark.parametrize("kw", [
    dict(quantization_type=tq.PER_TENSOR),
    dict(quantization_type=tq.PER_CHANNEL),
    dict(quantization_dtype="f8e4m3"),
    dict(activation_quantization_type="dynamic"),
], ids=["int8-tensor", "int8-channel", "fp8", "int8-dynamic"])
def test_quantized_generate_token_identical(tiny_hf_llama, kw):
    hf_model, hf_cfg = tiny_hf_llama
    got, want, japp, tapp = _generate_both(hf_model, hf_cfg, quantized=True, **kw)
    np.testing.assert_array_equal(got, want)
    # the params the port quantized are the JAX package's, bit for bit
    _assert_same_tree(tapp.params, jax.device_get(japp.params))


def test_quantized_kernel_flags_follow_jax_rules(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    with pytest.raises(ValueError, match="mlp_kernel_enabled composes"):
        port_app(hf_model, hf_cfg, quantized=True, mlp_kernel_enabled=True)
    app = port_app(hf_model, hf_cfg, quantized=True, fused_qkv=True, qkv_kernel_enabled=True)
    with pytest.raises(NotImplementedError, match="requires an unquantized"):
        HuggingFaceGenerationAdapter(app).generate(PROMPT, max_new_tokens=2)


def test_quantized_checkpoint_roundtrip(tiny_hf_llama, tmp_path):
    hf_model, hf_cfg = tiny_hf_llama
    online = port_app(hf_model, hf_cfg, quantized=True, quantization_dtype="f8e4m3")
    online.save_quantized_state_dict(str(tmp_path / "q"))
    offline = port_app(hf_model, hf_cfg, quantized=True, quantization_dtype="f8e4m3",
                       quantized_checkpoints_path=str(tmp_path / "q"))
    _assert_same_tree(offline.params, online.params)
    a = HuggingFaceGenerationAdapter(online).generate(PROMPT, max_new_tokens=6)
    b = HuggingFaceGenerationAdapter(offline).generate(PROMPT, max_new_tokens=6)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="does not match the configured"):
        port_app(hf_model, hf_cfg, quantized=True, quantization_dtype="int8",
                 quantized_checkpoints_path=str(tmp_path / "q"))
    with pytest.raises(FileNotFoundError):
        port_app(hf_model, hf_cfg, quantized=True,
                 quantized_checkpoints_path=str(tmp_path / "missing"))


def test_static_activation_calibration_matches_jax(tiny_hf_llama):
    """calibrate_app_input_scales on a dynamic-activation app gives the JAX
    package's per-layer input scales (same amax, same / 127)."""
    hf_model, hf_cfg = tiny_hf_llama
    kw = dict(quantized=True, activation_quantization_type="dynamic")
    japp, tapp = jax_app(hf_model, hf_cfg, **kw), port_app(hf_model, hf_cfg, **kw)
    prompts = [PROMPT[:, :6]]
    jparams = jq.calibrate_app_input_scales(japp, prompts)
    tparams = tq.calibrate_app_input_scales(tapp, prompts)
    for proj in ("q_proj", "o_proj"):
        np.testing.assert_allclose(
            tparams["layers"]["attn"][proj]["input_scale"].numpy(),
            np.asarray(jparams["layers"]["attn"][proj]["input_scale"]), rtol=1e-5)
    np.testing.assert_allclose(tparams["layers"]["mlp"]["down_proj"]["input_scale"].numpy(),
                               np.asarray(jparams["layers"]["mlp"]["down_proj"]["input_scale"]),
                               rtol=1e-5)
