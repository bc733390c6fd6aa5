"""The last dense families of the port, part 3: the learned-position lineage
(OPT, BioGPT, XGLM, GPT-2, BigCode multi-query and multi-head), each held to
the JAX package's family and HF as ``test_torch_dense_tier3.py`` describes;
the decode kernels' plain versions at a group of 24 query heads over one kv
head against the JAX decode kernels (interpret mode); the position table
under padded positions and the ``seq_len`` refusal; the refusals of the
new switches (learned positions, no rope, the head bias, xIELU) on the
paths that do not carry them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops.kernels import flash_attention as jfa
from nxdi_tpu_torch.config import TorchConfig
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.ops.kernels import flash_attention as tfa
from nxdi_tpu_torch.runtime.application import refuse_speculation, refuse_unported

from test_torch_dense_tier3 import (
    _tc,
    check_converter,
    check_default_gelu,
    check_family,
    fresh_jax_compiles,
    port_family_app,
    tiny_case,
)

PART_3 = ["opt", "biogpt", "xglm", "gpt2", "gpt_bigcode", "gpt_bigcode-mha"]


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@pytest.mark.parametrize("case", PART_3)
def test_family_matches_jax_and_hf(case):
    check_family(case)


@pytest.mark.parametrize("case", PART_3)
def test_converter_matches_jax(case):
    check_converter(case)


@pytest.mark.parametrize("case", ["biogpt", "xglm"])
def test_default_gelu_matches_hf(case):
    check_default_gelu(case)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["fused", "window", "paged"])
def test_decode_at_group_24_matches_pallas(mode):
    """The three decode modes' plain versions (what the wrappers run on the
    CPU) at 24 query heads over one kv head (a multi-query group above the
    kernels' 16-head tile) against the JAX decode kernels in interpret
    mode, f32 within 1e-5; on the card the grid takes two head tiles a kv
    head, which the decode split counts."""
    B, H, KV, D, W = 2, 24, 1, 16, 40
    q = _rand((B, H, 1, D), 0)
    q_pos = np.array([[29], [7]], np.int32)
    if mode == "paged":
        bs = 8
        kc, vc = _rand((12 * bs, KV, D), 1), _rand((12 * bs, KV, D), 2)
        bt = np.array([[3, 0, 7, 5, 9], [11, -1, 2, 4, 6]], np.int32)
        args = (q, kc, vc, bt, q_pos)
        ref = jfa.paged_attention_decode(*(jnp.asarray(x) for x in args), block_size=bs)
        got = tfa.paged_attention_decode(*(torch.from_numpy(x) for x in args), block_size=bs)
    else:
        kk, vv = _rand((B, KV, W, D), 1), _rand((B, KV, W, D), 2)
        kv_pos = np.tile(np.arange(W, dtype=np.int32), (B, 1))
        if mode == "fused":
            kn, vn = _rand((B, KV, 1, D), 3), _rand((B, KV, 1, D), 4)
            args = (q, kk, vv, kn, vn, q_pos, kv_pos)
            ref = jfa.flash_attention_decode_fused(*(jnp.asarray(x) for x in args), block_k=8)
            got = tfa.flash_attention_decode_fused(*(torch.from_numpy(x) for x in args))
        else:
            args = (q, kk, vv, q_pos, kv_pos)
            ref = jfa.flash_attention_decode(*(jnp.asarray(x) for x in args), block_k=8)
            got = tfa.flash_attention_decode(*(torch.from_numpy(x) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert [tfa.decode_head_tiles(h, 1) for h in (16, 24, 48, 71)] == [1, 2, 3, 5]
    assert tfa.decode_head_tiles(32, 2) == 1
    # the split counts the (row, kv head, head tile) triples as blocks: two
    # tiles a kv head want half the chunks
    assert tfa.decode_chunk(8, 1 * 2, 32768, 132) > tfa.decode_chunk(8, 1, 32768, 132)
    # no group limit on the card: an enabled decode flag at G 71 passes the gate
    assert tbase._card_limits(64, torch.bfloat16) == []


def test_padded_positions_past_the_table_read_its_last_row():
    """A GPT-2 whose position table has 16 rows: a forward whose padded
    lanes carry positions past the table (as a prefill's right padding and
    a K-step window can) gives the real rows' logits of the same forward
    with those lanes at the last row, and no index fault; a seq_len past
    the table is refused when the config is built."""
    model_type = "gpt2"
    _, cfg, sd = tiny_case("gpt2")
    cfg = dict(cfg, n_positions=16)
    sd = dict(sd, **{"transformer.wpe.weight": sd["transformer.wpe.weight"][:16]})
    app = port_family_app(model_type, cfg, sd=sd, seq_len=16, max_context_length=16)
    arch = app.models["context_encoding_model"].arch
    params, inv = app.params, app.models["context_encoding_model"].inv_freq

    def logits(pos):
        ids = torch.tensor([[5, 9, 3, 17, 2, 8, 11, 42, 0, 0, 0, 0]], dtype=torch.int32)
        cache = {k: v.clone() for k, v in app.kv_cache.items()}
        batch = dict(input_ids=ids, position_ids=torch.tensor([pos], dtype=torch.int32),
                     last_token_index=torch.tensor([7], dtype=torch.int32))
        out, _ = tbase.causal_lm_forward(arch, inv, params, cache, batch, attend_to_cache=False,
                                         gather_last_token=False, on_device_sampling=False)
        return out["logits"][0, :8]

    real = list(range(8))
    assert torch.equal(logits(real + [20, 21, 22, 23]), logits(real + [15] * 4))
    for name in ("gpt2", "opt"):
        _, c_cls = treg.get_family(name)
        c = dict(tiny_case(name)[1], n_positions=16, max_position_embeddings=16)
        with pytest.raises(ValueError, match=r"seq_len 32 exceeds .*\(16 positions\)"):
            c_cls(TorchConfig(**_tc(seq_len=32)), load_config=lambda: dict(c))


@pytest.mark.parametrize("case,switches", [
    ("gpt2", "learned_pos_embeds, no_rope"),
    ("phi", "lm_head_bias"),
    ("apertus", "xielu"),
])
def test_paths_carry_the_new_switches(case, switches):
    """Speculation (chains and token trees: these families have no window)
    and the mixed step pass app build on the learned positions, no rope,
    the head bias and xIELU, as LoRA and a quantized KV cache do (as in the
    JAX package); ``test_torch_family_spec*.py`` and
    ``test_torch_family_mixed.py`` run them."""
    from test_torch_dense_tier3 import CASES

    from nxdi_tpu_torch.runtime.application import family_switches

    model_type = CASES[case][0]
    family, cfg_cls = treg.get_family(model_type)
    cfg = tiny_case(case)[1]

    def config(**kw):
        return cfg_cls(TorchConfig(**_tc(**kw)), load_config=lambda: dict(cfg))

    arch = family.build_arch(config())
    assert set(switches.split(", ")) <= set(family_switches(arch))
    for tree in (False, True):
        refuse_speculation(arch, tree=tree)
    refuse_unported(family, config(mixed_dispatch=True, is_block_kv_layout=True))
    refuse_unported(family, config(lora_config=dict(max_loras=2, max_lora_rank=4,
                                                    target_modules=["q_proj"])))
    refuse_unported(family, config(kv_cache_quant=True))
