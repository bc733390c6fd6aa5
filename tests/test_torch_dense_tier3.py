"""The last dense families of the port, part 1 (StarCoder2, Falcon, GPT-NeoX,
Phi), with the helpers that parts 2 and 3 (``test_torch_dense_tier3_b.py``,
``test_torch_dense_tier3_c.py``) share. Each case is one of the JAX package's
own tiny configs (``tests/integration/test_contrib_dense_families.py``,
``test_model_families.py``'s GPT-2; Orion's reference is a Llama with
biased LayerNorms, as in ``test_remote_code_families.py``) at 2 layers,
its projections scaled up (:data:`WEIGHT_SCALE`) so the greedy tokens vary:

- the port's app on the JAX app's params (``from_jax_params``): float32
  prefill logits within 1e-5 of the JAX app's, greedy tokens over 16 new
  ones equal to the JAX app's and to HF's, the attention kernels' plain
  versions run where the JAX rule runs its (Pallas, interpret mode);
- the port's converter of the HF checkpoint against the JAX converter,
  leaf for leaf; ``random_params`` builds the same tree.

HF's ``"gelu"`` is the exact GELU, the JAX package's the tanh one (ROADMAP
Queue 3): Falcon, GPT-NeoX, BioGPT and XGLM are held to the JAX package
with both configs naming ``gelu_pytorch_tanh`` (one function on both sides),
and with their default ``"gelu"`` to HF alone (:func:`check_default_gelu`)."""

import functools

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.models import registry as jreg
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.models.convert import from_jax_params

from test_torch_families import (
    LOGIT_TOL,
    _tc,
    jax_family_app,
    port_family_app,
    prefill_logits,
    strategies,
)
from test_torch_slice import fresh_jax_compiles

PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)
NEW = 16
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=256, max_position_embeddings=256,
            tie_word_embeddings=False)
TANH = "gelu_pytorch_tanh"
# case -> (model type, transformers class, config overrides, the key that
# names the activation where HF's "gelu" is exact, or None)
CASES = {
    "starcoder2": ("starcoder2", "Starcoder2ForCausalLM", dict(
        use_bias=True, norm_epsilon=1e-5, rope_theta=10000.0, hidden_act=TANH,
        sliding_window=None, residual_dropout=0.0, embedding_dropout=0.0), None),
    "falcon-7b-style": ("falcon", "FalconForCausalLM", dict(
        multi_query=True, parallel_attn=True, new_decoder_architecture=False, bias=False,
        alibi=False, rope_theta=10000.0, tie_word_embeddings=True), "activation"),
    "falcon-new-arch": ("falcon", "FalconForCausalLM", dict(
        multi_query=False, parallel_attn=True, new_decoder_architecture=True, num_kv_heads=2,
        bias=True, alibi=False, rope_theta=10000.0, tie_word_embeddings=True), "activation"),
    "gpt_neox-parallel": ("gpt_neox", "GPTNeoXForCausalLM", dict(
        rotary_pct=0.25, rotary_emb_base=10000.0, use_parallel_residual=True,
        layer_norm_eps=1e-5, attention_bias=True), "hidden_act"),
    "gpt_neox-sequential": ("gpt_neox", "GPTNeoXForCausalLM", dict(
        rotary_pct=0.25, rotary_emb_base=10000.0, use_parallel_residual=False,
        layer_norm_eps=1e-5, attention_bias=True), "hidden_act"),
    "phi": ("phi", "PhiForCausalLM", dict(
        partial_rotary_factor=0.5, hidden_act="gelu_new", rope_theta=10000.0), None),
    "stablelm": ("stablelm", "StableLmForCausalLM", dict(
        partial_rotary_factor=0.25, use_qkv_bias=True, layer_norm_eps=1e-5,
        rope_theta=10000.0), None),
    "glm4": ("glm4", "Glm4ForCausalLM", dict(
        partial_rotary_factor=0.5, attention_bias=True, head_dim=16, rope_theta=10000.0,
        pad_token_id=0, eos_token_id=None), None),
    "persimmon": ("persimmon", "PersimmonForCausalLM", dict(
        hidden_act="relu2", partial_rotary_factor=0.5, qk_layernorm=True,
        rope_theta=10000.0), None),
    "apertus": ("apertus", "ApertusForCausalLM", dict(rope_theta=10000.0, rope_scaling=None),
                None),
    # no transformers class: a Llama whose norms are biased LayerNorms
    "orion": ("orion", None, dict(rms_norm_eps=1e-5, rope_theta=10000.0), None),
    "opt": ("opt", "OPTForCausalLM", dict(
        ffn_dim=128, word_embed_proj_dim=64, do_layer_norm_before=True,
        activation_function="relu", tie_word_embeddings=True), None),
    "biogpt": ("biogpt", "BioGptForCausalLM", dict(
        scale_embedding=True, tie_word_embeddings=True), "hidden_act"),
    "xglm": ("xglm", "XGLMForCausalLM", dict(ffn_dim=128, tie_word_embeddings=True),
             "activation_function"),
    "gpt_bigcode": ("gpt_bigcode", "GPTBigCodeForCausalLM", dict(
        multi_query=True, activation_function=TANH, tie_word_embeddings=True), None),
    "gpt_bigcode-mha": ("gpt_bigcode", "GPTBigCodeForCausalLM", dict(
        multi_query=False, activation_function=TANH, tie_word_embeddings=True), None),
    # test_model_families.py's GPT-2 (n_inner 128), at 2 layers
    "gpt2": ("gpt2", "GPT2LMHeadModel", dict(
        n_embd=64, n_head=4, n_layer=2, n_positions=256, vocab_size=256, n_inner=128,
        eos_token_id=None, bos_token_id=None), None),
}
# the projections' weights (2-D, but the embeddings, position tables and
# head) are scaled up from HF's init, so the layers' branches outweigh the
# tied embeddings and the greedy tokens vary; BioGPT's and XGLM's scaled
# token embeddings and positions need more
WEIGHT_SCALE = {"biogpt": 32.0, "xglm": 32.0}
PART_1 = ["starcoder2", "falcon-7b-style", "falcon-new-arch", "gpt_neox-parallel",
          "gpt_neox-sequential", "phi"]


def _orion_reference(cfg_kw):
    """A tiny Llama whose three norms are biased LayerNorms (Orion's block;
    its HF class is remote code), weights and biases drawn away from the
    identity so the biases bite."""
    import transformers

    cfg = transformers.LlamaConfig(**cfg_kw)
    model = transformers.LlamaForCausalLM(cfg).eval()
    H, eps = cfg.hidden_size, cfg.rms_norm_eps
    slots = [(model.model, "norm")] + [(layer, name) for layer in model.model.layers
                                       for name in ("input_layernorm",
                                                    "post_attention_layernorm")]
    with torch.no_grad():
        for owner, name in slots:
            norm = torch.nn.LayerNorm(H, eps=eps)
            norm.weight.normal_(1.0, 0.2)
            norm.bias.normal_(0.0, 0.2)
            setattr(owner, name, norm)
    return model.eval(), dict(cfg.to_dict(), model_type="orion")


@functools.lru_cache(maxsize=None)
def tiny_case(case, tanh=True):
    """(HF model, its config dict, the state dict as numpy) of ``case``;
    ``tanh``: a GELU family's activation set to gelu_pytorch_tanh (the
    function both packages compute), else its default "gelu"."""
    import transformers

    model_type, cls_name, over, act_key = CASES[case]
    over = dict(over)
    if act_key is not None and tanh:
        over[act_key] = TANH
    torch.manual_seed(0)
    kw = over if model_type == "gpt2" else {**TINY, **over}
    if cls_name is None:
        model, cfg = _orion_reference(kw)
    else:
        cfg_cls = getattr(transformers, cls_name.replace("ForCausalLM", "Config").replace(
            "LMHeadModel", "Config"))
        model = getattr(transformers, cls_name)(cfg_cls(**kw)).eval()
        cfg = model.config.to_dict()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2 and not any(k in name for k in ("embed", "wte", "wpe", "lm_head")):
                p.mul_(WEIGHT_SCALE.get(case, 4.0))
    # Apertus keeps its xIELU learnables in bf16, which numpy has not: widened
    # exactly, the converters round them again
    sd = {k: (v.detach().float() if v.dtype == torch.bfloat16 else v.detach()).numpy()
          for k, v in model.state_dict().items()}
    return model, cfg, sd


@functools.lru_cache(maxsize=None)
def apps(case):
    """(JAX app on the HF checkpoint, the port's app on the JAX app's params)."""
    model_type = CASES[case][0]
    _, cfg, sd = tiny_case(case)
    japp = jax_family_app(model_type, cfg, sd)
    tapp = port_family_app(model_type, cfg, params=from_jax_params(jax.device_get(japp.params)))
    return japp, tapp


def check_family(case):
    """The port against the JAX app (prefill logits, greedy tokens) and HF
    (greedy tokens); the strategies the JAX rule picks with the attention
    kernel flags on."""
    hf_model = tiny_case(case)[0]
    japp, tapp = apps(case)
    np.testing.assert_allclose(prefill_logits(tapp, PROMPT), prefill_logits(japp, PROMPT),
                               atol=LOGIT_TOL, rtol=0)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW))
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPT, NEW))
    assert len(set(got[0, PROMPT.shape[1]:].tolist())) > 2  # the tokens move
    seen = strategies(tapp)
    assert seen["context_encoding_model"] == {"cte_flash_kernel"}
    assert seen["token_generation_model"] == {"tkg_fused_kernel_stacked"}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def configs(case, cfg=None, **tc):
    """(JAX config, port config) of the case's HF config."""
    model_type = CASES[case][0]
    cfg = cfg or tiny_case(case)[1]
    return (jreg.get_family(model_type)[1](TpuConfig(**_tc(**tc)), load_config=lambda: dict(cfg)),
            treg.get_family(model_type)[1](TorchConfig(**_tc(**tc)),
                                           load_config=lambda: dict(cfg)))


def check_converter(case):
    """The port's converter of the HF checkpoint gives the JAX converter's
    params leaf for leaf (keys, dtypes, values), and the family's
    random_params (or dense.random_params: chip_smoke.py's rule) the same
    tree (shapes and dtypes)."""
    model_type = CASES[case][0]
    _, _, sd = tiny_case(case)
    jcfg, tcfg = configs(case)
    jfam, tfam = jreg.get_family(model_type)[0], treg.get_family(model_type)[0]
    want = dict(_leaves(from_jax_params(jfam.convert_hf_state_dict(sd, jcfg))))
    got = dict(_leaves(tfam.convert_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))
    rand = dict(_leaves(tfam.random_params(tcfg, device="cpu") if hasattr(tfam, "random_params")
                        else dense.random_params(tfam.build_arch(tcfg), device="cpu")))
    assert rand.keys() == got.keys()
    for k in got:
        assert (rand[k].shape, rand[k].dtype) == (got[k].shape, got[k].dtype), k


def check_default_gelu(case):
    """A GELU family with its default "gelu" (HF's exact GELU) against HF:
    prefill logits within 1e-5 and greedy tokens; its arch names the exact
    GELU. The tanh GELU would give other logits (the JAX package's, ROADMAP
    Queue 3)."""
    model_type = CASES[case][0]
    hf_model, cfg, sd = tiny_case(case, tanh=False)
    tapp = port_family_app(model_type, cfg, sd=sd)
    assert tapp.family.build_arch(tapp.config).hidden_act == "gelu_exact"
    with torch.no_grad():
        want = hf_model(torch.from_numpy(PROMPT)).logits[:, -1].numpy()
    got = prefill_logits(tapp, PROMPT)[:, -1]
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(HuggingFaceGenerationAdapter(tapp).generate(
        PROMPT, max_new_tokens=NEW), hf_greedy_generate(hf_model, PROMPT, NEW))


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@pytest.mark.parametrize("case", PART_1)
def test_family_matches_jax_and_hf(case):
    check_family(case)


@pytest.mark.parametrize("case", PART_1)
def test_converter_matches_jax(case):
    check_converter(case)


@pytest.mark.parametrize("case", ["falcon-7b-style", "gpt_neox-parallel"])
def test_default_gelu_matches_hf(case):
    check_default_gelu(case)


def test_published_widths():
    """Falcon-7B and StarCoder2-15B build their archs at the published
    widths: Falcon's 71 query heads of 64 on one kv head (G 71), the
    parallel block, the exact GELU, no biases, a tied head; StarCoder2's 48
    over 4 heads of 128, windows of 4096, biases everywhere."""
    from nxdi_tpu_torch.models.falcon import modeling_falcon as tf
    from nxdi_tpu_torch.models.starcoder2 import modeling_starcoder2 as ts

    tc = TorchConfig(**_tc(dtype="bfloat16", seq_len=8192))
    a = tf.build_arch(tf.FalconInferenceConfig(tc, **tf.FALCON_7B))
    assert (a.num_layers, a.hidden_size, a.num_attention_heads, a.num_kv_heads,
            a.head_dim) == (32, 4544, 71, 1, 64)
    assert (a.intermediate_size, a.vocab_size, a.hidden_act) == (18176, 65024, "gelu_exact")
    assert a.parallel_block and a.layernorm and a.tie_word_embeddings and not a.attention_bias
    s = ts.build_arch(ts.Starcoder2InferenceConfig(tc, **ts.STARCODER2_15B))
    assert (s.num_layers, s.num_attention_heads, s.num_kv_heads, s.head_dim) == (40, 48, 4, 128)
    assert (s.intermediate_size, s.vocab_size, s.sliding_window) == (24576, 49152, 4096)
    assert s.attention_bias and s.attention_o_bias and s.mlp_bias and not s.gated_mlp
