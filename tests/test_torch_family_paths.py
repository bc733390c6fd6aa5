"""LoRA serving and quantized KV stores on the family switches, held to the
JAX package, part 1 (the dense families), with the helpers part 2
(``test_torch_family_paths_b.py``: the MoE families, LongRoPE, xIELU, the
ring under a one-byte store and the refusals kept) shares.

The JAX package serves both paths on every family; the port now does too.
Each case is a tiny 2-layer family from the family test files, chosen so
that together they turn on every switch of ``family_switches`` (and the
Gemma-3 local rope pair) at least once (:func:`test_cases_cover_every_switch`).
One app per case and package serves a rank-4 LoRA adapter on every
targetable projection the family has (a non-gated MLP has no ``gate_proj``,
an MoE layer no dense MLP: the JAX ``attach_lora_buffers`` skips them, and
so does the port) over a one-byte KV store with per-tensor scales (the
store cycles through e4m3, e5m2 and int8 by case). Both apps build from the
same HF state dict; the greedy tokens of the adapter's slot and of the base
slot 0 must equal the JAX app's, and the adapter must move them."""

import functools
import inspect
import re

import numpy as np
import pytest
import torch

from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.runtime.application import family_switches, local_rope

from test_torch_families import jax_family_app, port_family_app
from test_torch_slice import fresh_jax_compiles

PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4]], dtype=np.int64)
NEW = 10
RANK = 4
ALPHA = 8.0
ADAPTER_CFG = {"r": RANK, "lora_alpha": ALPHA}
TARGETS = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]
# per-tensor scales: the stores' values land well inside each type's range
KV_STORES = [dict(dtype="float8_e4m3", scale_mode="per_tensor", k_scale=0.25, v_scale=0.125),
             dict(dtype="float8_e5m2", scale_mode="per_tensor", k_scale=0.5, v_scale=0.25),
             dict(dtype="int8", scale_mode="per_tensor", k_scale=0.05, v_scale=0.02)]
# case -> (the test module that builds it, its key there); part 1 below,
# part 2 in test_torch_family_paths_b.py
DENSE = {
    "gemma3_text": ("test_torch_gemma", "gemma3_text"),
    "gemma2": ("test_torch_gemma", "gemma2"),
    "phi": ("test_torch_dense_tier3", "phi"),
    "opt": ("test_torch_dense_tier3", "opt"),
    "granite": ("test_torch_families", "granite"),
    "olmo2": ("test_torch_families", "olmo2"),
    "helium": ("test_torch_families", "helium"),
}
OTHERS = {
    "dbrx": ("test_torch_moe_families", "dbrx"),
    "gpt_oss": ("test_torch_moe_families", "gpt_oss"),
    "afmoe": ("test_torch_moe_families", "afmoe"),
    "phi3_longrope": ("test_torch_moe_families", "phi3_longrope"),
    "llama4_text": ("test_torch_llama4", None),
    "apertus": ("test_torch_dense_tier3", "apertus"),
}
ALL_CASES = {**DENSE, **OTHERS}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@functools.lru_cache(maxsize=None)
def tiny(case):
    """(model type, HF config dict, state dict as numpy) of ``case``, from
    its family test module (its tiny_case or tiny_family)."""
    import importlib

    module, key = ALL_CASES[case]
    mod = importlib.import_module(module)
    if module == "test_torch_moe_families":
        model_type, _, cfg, sd = mod.tiny_case(key)
        if key == "afmoe":  # every layer MoE: a segmented stack refuses LoRA (kept)
            cfg = dict(cfg, num_dense_layers=0)
            sd = mod._afmoe_sd(cfg, np.random.default_rng(0))
        return model_type, cfg, sd
    if module == "test_torch_llama4":
        _, cfg, sd = mod.tiny_case()
        return "llama4_text", cfg, sd
    if module == "test_torch_families":
        _, cfg, sd = mod.tiny_family(key)
        return key, cfg, sd
    _, cfg, sd = mod.tiny_case(key)
    model_type = mod.CASES[key][0] if module == "test_torch_dense_tier3" else key
    return model_type, cfg, sd


def adapter_sd(arch, seed, scale=0.3):
    """A PEFT adapter over every targetable module in the port's widths
    (``lora/serving._module_dims``), every layer; the converters of both
    packages skip a module the family lacks."""
    from nxdi_tpu_torch.lora.serving import LORA_TARGETABLE_MODULES, _module_dims

    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(arch.num_layers):
        for m in TARGETS:
            fin, fout = _module_dims(arch, m)
            scope = LORA_TARGETABLE_MODULES[m][1]
            key = f"base_model.model.model.layers.{i}.{scope}.{m}.lora_"
            sd[key + "A.weight"] = (rng.standard_normal((RANK, fin)) * scale).astype(np.float32)
            sd[key + "B.weight"] = (rng.standard_normal((fout, RANK)) * scale).astype(np.float32)
    return sd


def path_kw(case):
    """The app options of a case: LoRA on every target, 2 slots, over a
    one-byte KV store."""
    store = KV_STORES[sorted(ALL_CASES).index(case) % len(KV_STORES)]
    return dict(lora_config=dict(max_loras=2, max_lora_rank=RANK, target_modules=TARGETS,
                                 lora_dtype="float32", lora_alpha=ALPHA),
                kv_quant_config=dict(store))


def check_case(case, **extra):
    """The port's LoRA + quantized-KV app against the JAX package's: greedy
    tokens of the adapter's slot and of the base slot equal, the adapter
    moving them; the pool holds the one-byte store; the LoRA buffers sit on
    the projections the layer has."""
    model_type, cfg, sd = tiny(case)
    kw = {**path_kw(case), **extra}
    japp = jax_family_app(model_type, cfg, sd, **kw)
    tapp = port_family_app(model_type, cfg, sd=sd, **kw)
    arch = tapp.models["token_generation_model"].arch
    asd = adapter_sd(arch, seed=sorted(ALL_CASES).index(case))
    outs = []
    for app, Adapter in ((japp, JaxAdapter), (tapp, HuggingFaceGenerationAdapter)):
        slot = app.set_lora_adapter("a", asd, adapter_cfg=ADAPTER_CFG)
        assert slot == 1
        gen = Adapter(app)
        outs.append([np.asarray(gen.generate(PROMPT, max_new_tokens=NEW,
                                             adapter_ids=np.array([s]))) for s in (slot, 0)])
    (j_lora, j_base), (t_lora, t_base) = outs
    np.testing.assert_array_equal(t_lora, j_lora)
    np.testing.assert_array_equal(t_base, j_base)
    assert not np.array_equal(t_lora, t_base)  # the adapter moves the tokens
    store = {"float8_e4m3": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
             "int8": torch.int8}[kw["kv_quant_config"]["dtype"]]
    assert tapp.kv_cache["k"].dtype == store
    from nxdi_tpu_torch.lora.serving import LORA_TARGETABLE_MODULES

    layers = tapp.params["layers"]
    present = {m: layers[g][p] for m, ((g, p), _) in LORA_TARGETABLE_MODULES.items()
               if p in layers.get(g, {})}
    assert {m for m, d in present.items() if "lora_A" in d} == set(present)
    return tapp


@pytest.mark.parametrize("case", sorted(DENSE))
def test_lora_and_quantized_kv_match_jax(case):
    check_case(case)


def test_cases_cover_every_switch():
    """The cases of both parts turn on every switch ``family_switches``
    names (and the Gemma-3 local rope pair), so each is served under LoRA
    and a quantized KV store at least once."""
    from nxdi_tpu_torch.config import TorchConfig
    from nxdi_tpu_torch.models import registry as treg

    from test_torch_families import _tc

    seen = set()
    for case in ALL_CASES:
        model_type, cfg, _ = tiny(case)
        family, cfg_cls = treg.get_family(model_type)
        config = cfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg))
        arch = family.build_arch(config)
        seen |= {s.split("=")[0] for s in family_switches(arch)}
        if local_rope(family, config):
            seen.add("use_local_rope")
    # every switch the function can name, read off its source
    want = set(re.findall(r'^\s*\(f?"([a-z_0-9]+)', inspect.getsource(family_switches),
                          re.M))
    assert len(want) > 25
    assert want | {"use_local_rope"} <= seen, sorted(want - seen)
