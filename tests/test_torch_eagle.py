"""The port's EAGLE and EAGLE3 speculation (``nxdi_tpu_torch/speculation/
eagle.py``, ``models/llama_eagle.py``) held against the JAX package's on the
CPU: the config keys, the draft conversion, the forward's EAGLE paths (the
``fc`` fusion, ``input_norm_skip``, a model without a final norm,
``aux_hidden``), the dynamic tree's shape and mask, the shared best-path
K/V move, and the windows — chain, EAGLE3 with a reduced vocabulary, the
static token tree and the dynamic tree — window by window, plus the
refusals.

Both packages run the same weights: a tiny random HF llama target (hidden 64,
vocab 256, 4 layers, float32, seed 0) and synthetic 1-layer EAGLE drafts
built like the JAX package's test drafts (no layer-0 input norm, no final
norm, no embedding: borrowed from the target; EAGLE3 adds ``fc_features``,
a reduced-vocab lm_head and ``d2t``), carried across with
``from_jax_params``. A random draft is seldom accepted, so the windows also
run a "strong" pair: the target with its layers' output projections scaled
down (near a bigram model of its embedding and lm_head) and a draft whose
``fc`` passes the token embedding through with a little of the feature,
which the target accepts often, trees along paths of every depth. The JAX
references run plain attention, as the JAX package's own EAGLE tests do,
and compile under ``fresh_jax_compiles()``; the port runs with its
attention kernel flags on (their plain versions on the CPU).
Greedy tokens must equal the JAX package's and HF's; every window's accepted
count equals the JAX package's, and the features buffer and both caches
agree within 1e-5 after every window."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import SpeculationConfig as JaxSpecConfig
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.kvcache.kv_cache import init_kv_cache as jax_init_kv_cache
from nxdi_tpu.models import llama_eagle as jle
from nxdi_tpu.models.base import causal_lm_forward as jax_forward
from nxdi_tpu.models.llama import modeling_llama as jml
from nxdi_tpu.speculation import EagleSpecCausalLM as JaxEagle
from nxdi_tpu.speculation import token_tree as jtt
from nxdi_tpu.utils.accuracy import hf_greedy_generate as hf_greedy
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, SpeculationConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.kvcache.kv_cache import init_kv_cache
from nxdi_tpu_torch.models import llama_eagle as tle
from nxdi_tpu_torch.models.base import causal_lm_forward
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.runtime.model_wrapper import TAG_FUSED_SPECULATION
from nxdi_tpu_torch.speculation import EagleSpecCausalLM
from nxdi_tpu_torch.speculation import token_tree as ttt
from test_torch_slice import fresh_jax_compiles
from test_torch_speculation import _sd, _tiny_hf_llama

PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)
TREE = [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0], [0, 1, 0]]  # the JAX package's test tree
H, VOCAB, DRAFT_VOCAB = 64, 256, 128
TOL = 1e-5  # float32 caches, features and forward outputs, the port's against the JAX package's

# the window configurations: (draft seed, spec_len, extra draft / app settings)
CONFIGS = {
    "chain": (3, 3, {}),
    "eagle3": (5, 3, {"eagle3": True}),
    "tree": (1, 3, {"token_tree_config": {"choices": TREE}}),
    "dynamic_m1": (1, 3, {"token_tree_config": {"dynamic": {
        "steps": 3, "branching_factor": 2, "num_inputs": 1}}}),
    "dynamic_m2": (1, 3, {"token_tree_config": {"dynamic": {
        "steps": 3, "branching_factor": 2, "num_inputs": 2}}}),
}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


STRONG_SCALE = 0.05  # the strong pair's output projections, scaled


def _scaled_outputs(sd):
    return {k: v * STRONG_SCALE if ("o_proj" in k or "down_proj" in k) else v
            for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _target(strong=False):
    model, cfg = _tiny_hf_llama(0, 4)
    if strong:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               _scaled_outputs(_sd(model)).items()})
    return model, cfg


def _eagle_draft_sd(seed, eagle3=False, input_norm=False, final_norm=False, strong=False):
    """A synthetic 1-layer EAGLE draft checkpoint (the JAX package's test
    drafts): a llama layer without its input norm (``input_norm``: with it)
    and without a final norm (``final_norm``: with it), no embedding or
    lm_head, plus ``fc``. EAGLE3 adds ``fc_features`` over the target's aux
    layers, a DRAFT_VOCAB lm_head and a ``d2t`` table. ``strong``: the
    strong pair's draft (``fc`` = [I | 0.05 R], the layer's outputs scaled;
    EAGLE3's lm_head the target's rows at ``d2t``)."""
    base, _ = _tiny_hf_llama(seed, 1)
    rng = np.random.default_rng(seed)
    sd = _sd(base)
    if strong:
        sd = _scaled_outputs(sd)
    out = {}
    for k, v in sd.items():
        if ("input_layernorm" in k and not input_norm) or (k == "model.norm.weight"
                                                            and not final_norm):
            continue
        if "embed_tokens" in k or k == "lm_head.weight":
            continue
        out[k] = v
    out["fc.weight"] = (rng.standard_normal((H, 2 * H)) * 0.05).astype(np.float32)
    out["fc.bias"] = (rng.standard_normal((H,)) * 0.01).astype(np.float32)
    if strong:
        out["fc.weight"][:, :H] = np.eye(H, dtype=np.float32)
        out["fc.bias"][:] = 0
    if eagle3:
        aux_k = len(tle.eagle3_aux_indices_default(4))
        out["fc_features.weight"] = (rng.standard_normal((H, aux_k * H)) * 0.05).astype(np.float32)
        out["lm_head.weight"] = (rng.standard_normal((DRAFT_VOCAB, H)) * 0.05).astype(np.float32)
        out["d2t"] = rng.choice(VOCAB, size=DRAFT_VOCAB, replace=False).astype(np.int32)
        if strong:
            out["lm_head.weight"] = _sd(_target(True)[0])["lm_head.weight"][out["d2t"]]
    return out


def _common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
             attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, skip_warmup=True)
    d.update(kw)
    return d


def _cfgs(jax_side, spec_len, eagle3, **kw):
    """(target config, draft config) of one package."""
    _, tcfg = _target()
    draft_hf = dict(tcfg.to_dict(), num_hidden_layers=1)
    if eagle3:
        draft_hf["vocab_size"] = DRAFT_VOCAB
    spec = dict(speculation_length=spec_len, enable_eagle_speculation=True, is_eagle3=eagle3)
    if jax_side:
        Cfg, Spec, Odsc, fam, dfam = TpuConfig, JaxSpecConfig, JaxODSC, jml, jle
        # the JAX package's own EAGLE tests: plain attention (no Pallas kernels)
        kw = dict(dict(attn_kernel_enabled=False, attn_tkg_kernel_enabled=False), **kw)
    else:
        Cfg, Spec, Odsc, fam, dfam = TorchConfig, SpeculationConfig, OnDeviceSamplingConfig, tml, tle
    t = fam.LlamaInferenceConfig(
        Cfg(on_device_sampling_config=Odsc(), speculation_config=Spec(**spec), **_common(**kw)),
        load_config=lambda: tcfg.to_dict())
    d = dfam.LlamaEagleInferenceConfig(
        Cfg(on_device_sampling_config=Odsc(), is_eagle3=eagle3, **_common(**kw)),
        load_config=lambda: draft_hf)
    return t, d


def _jax_app(draft_sd, spec_len, eagle3=False, strong=False, **kw):
    t_sd = _sd(_target(strong)[0])

    class JApp(JaxEagle):
        def get_state_dict(self):
            return t_sd

        def get_draft_state_dict(self):
            return draft_sd

    tcfg, dcfg = _cfgs(True, spec_len, eagle3, **kw)
    japp = JApp("<t>", tcfg, "<d>", dcfg, model_family=jml)
    japp.load()
    return japp


def _port_app(params, spec_len, eagle3=False, **kw):
    class TApp(EagleSpecCausalLM):
        def build_params(self):
            return params

    tcfg, dcfg = _cfgs(False, spec_len, eagle3, **kw)
    tapp = TApp("<t>", tcfg, "<d>", dcfg, model_family=tml, device="cpu")
    tapp.load()
    return tapp


@functools.lru_cache(maxsize=None)
def _pair(kind, batch_size=1, draft="random", draft_seed=None, **kw):
    """The JAX package's EAGLE app and the port's on its params: the random
    or the strong pair (``draft_seed``: another draft than the
    configuration's)."""
    seed, spec_len, extra = CONFIGS[kind]
    extra = dict(extra, **kw)
    eagle3 = extra.pop("eagle3", False)
    strong = draft == "strong"
    draft_sd = _eagle_draft_sd(seed if draft_seed is None else draft_seed, eagle3=eagle3,
                               strong=strong)
    japp = _jax_app(draft_sd, spec_len, eagle3, strong, batch_size=batch_size, **extra)
    tapp = _port_app(from_jax_params(jax.device_get(japp.params)), spec_len, eagle3,
                     batch_size=batch_size, **extra)
    return japp, tapp


@functools.lru_cache(maxsize=None)
def _hf(prompt: tuple, n: int, strong=False) -> np.ndarray:
    return hf_greedy(_target(strong)[0], np.array([prompt]), max_new_tokens=n)[0]


def _flat_cache(cache):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return {k: v.numpy().copy() if isinstance(v, torch.Tensor)
            else np.asarray(jax.device_get(v)) for k, v in out.items()}


def _windows(app):
    """Record every window dispatch of ``app``: its counts and the caches
    (both models' K/V and the features buffer) after it."""
    log = []
    inner = app.forward

    def fwd(input_ids, position_ids, **kw):
        out = inner(input_ids, position_ids, **kw)
        if np.asarray(input_ids).shape[1] == 1:
            c = out["counts"]
            c = c.numpy() if isinstance(c, torch.Tensor) else np.asarray(jax.device_get(c))
            log.append((c.tolist(), _flat_cache(app.kv_cache)))
        return out

    app.forward = fwd
    return log


def _batch_prompt(B):
    if B == 1:
        return PROMPT, None, [PROMPT[0].tolist()]
    p0, p1 = [5, 9, 3, 17, 2, 8, 11, 42], [7, 13, 21, 4]
    prompt = np.zeros((2, 8), dtype=np.int64)
    prompt[0], prompt[1, :4] = p0, p1
    return prompt, (prompt != 0).astype(np.int32), [p0, p1]


@functools.lru_cache(maxsize=None)
def _generate(kind, B, n, **kw):
    """generate() on both apps of ``_pair(kind, B, **kw)``: (JAX tokens,
    port tokens, JAX windows, port windows)."""
    japp, tapp = _pair(kind, B, **kw)
    prompt, mask, _ = _batch_prompt(B)
    jlog, tlog = _windows(japp), _windows(tapp)
    gen = dict(max_new_tokens=n) if mask is None else dict(attention_mask=mask, max_new_tokens=n)
    try:
        jout = JaxAdapter(japp).generate(prompt, **gen)
        tout = HuggingFaceGenerationAdapter(tapp).generate(prompt, **gen)
    finally:
        del japp.forward, tapp.forward
    return jout, tout, jlog, tlog


def _assert_windows_equal(jlog, tlog):
    assert [c for c, _ in tlog] == [c for c, _ in jlog] and len(tlog) > 0
    for (_, tc), (_, jc) in zip(tlog, jlog):
        assert tc.keys() == jc.keys() == {"draft.k", "draft.v", "target.k", "target.v",
                                          "features"}
        for key in tc:
            np.testing.assert_allclose(tc[key], jc[key], atol=TOL, rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


EAGLE_KEYS = {"enable_eagle_speculation": True, "is_eagle3": True, "is_eagle_draft": True,
              "token_tree_config": {"choices": TREE}}


@pytest.mark.parametrize("key", sorted(EAGLE_KEYS))
@pytest.mark.parametrize("where", ["config", "speculation_config"])
def test_eagle_keys_match_jax(key, where):
    """Each EAGLE key at either level gives TorchConfig the attributes it
    gives TpuConfig (``enable_eagle_speculation`` implies the fused window),
    and ``to_dict`` round-trips it."""
    value = EAGLE_KEYS[key]
    kw = {key: value} if where == "config" else {"speculation_config": {key: value}}
    j, t = TpuConfig(**kw), TorchConfig(**kw)
    for attr in (*EAGLE_KEYS, "enable_fused_speculation"):
        assert getattr(t, attr) == getattr(j, attr), attr
    if key == "enable_eagle_speculation":
        assert t.enable_fused_speculation
    again = TorchConfig.from_dict(t.to_dict())
    for attr in (*EAGLE_KEYS, "enable_fused_speculation"):
        assert getattr(again, attr) == getattr(t, attr), attr
    if where == "speculation_config":
        assert again.speculation_config.to_dict() == j.speculation_config.to_dict()


# ---------------------------------------------------------------------------
# conversion and the forward's EAGLE paths
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_params_equal(port, jax_params):
    want = dict(_leaves(from_jax_params(jax.device_get(jax_params))))
    got = dict(_leaves(port))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _draft_cfgs(eagle3):
    return _cfgs(True, 3, eagle3)[1], _cfgs(False, 3, eagle3)[1]


@pytest.mark.parametrize("eagle3", [False, True], ids=["eagle", "eagle3"])
def test_draft_conversion_matches_jax(eagle3):
    """``llama_eagle.convert_hf_state_dict`` equals the JAX package's, leaf
    for leaf (with the target's embedding borrowed as the application does;
    EAGLE3 with a reduced vocab and d2t), and its refusal of an EAGLE3
    checkpoint without ``fc_features``."""
    sd = _eagle_draft_sd(5, eagle3=eagle3)
    sd["embed_tokens.weight"] = _sd(_target()[0])["model.embed_tokens.weight"]
    if not eagle3:
        sd["lm_head.weight"] = _sd(_target()[0])["lm_head.weight"]
    dj, dt = _draft_cfgs(eagle3)
    want = jle.convert_hf_state_dict(sd, dj)
    got = tle.convert_hf_state_dict(sd, dt)
    _assert_params_equal(got, want)
    assert "norm" not in got and bool(got["layers"]["input_norm_skip"][0])
    if eagle3:
        assert got["embed_tokens"].shape == (VOCAB, H) and got["lm_head"].shape == (H, DRAFT_VOCAB)
        del sd["fc_features.weight"]
        for fn, cfg in ((jle.convert_hf_state_dict, dj), (tle.convert_hf_state_dict, dt)):
            with pytest.raises(KeyError, match="fc_features"):
                fn(sd, cfg)


@pytest.mark.parametrize("eagle3", [False, True], ids=["eagle", "eagle3"])
def test_random_draft_has_the_converted_layout(eagle3):
    """``llama_eagle.random_params`` (the card's random drafts) builds the
    tree the app's conversion builds: the same keys, shapes and dtypes, the
    target's embedding (and, for EAGLE, its lm_head), distinct ``d2t`` ids."""
    japp, _ = _pair("eagle3" if eagle3 else "chain")
    want = dict(_leaves(from_jax_params(jax.device_get(japp.params["draft"]))))
    target = from_jax_params(jax.device_get(japp.params["target"]))
    got = dict(_leaves(tle.random_params(_draft_cfgs(eagle3)[1], target, target_num_layers=4,
                                         seed=1, device="cpu")))
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
    assert got["embed_tokens"] is target["embed_tokens"]
    assert bool(got["layers.input_norm_skip"].all())
    if eagle3:
        assert len(set(got["d2t"].tolist())) == DRAFT_VOCAB
    else:
        assert got["lm_head"] is target["lm_head"]


@pytest.mark.parametrize("kind", ["eagle", "eagle3"])
def test_app_params_borrow_the_targets_weights(kind):
    """The port's app reading the checkpoints itself (the draft borrows the
    target's embedding, and its lm_head when the vocabularies match) builds
    the JAX app's params exactly."""
    japp, _ = _pair("chain" if kind == "eagle" else "eagle3")
    seed, spec_len, extra = CONFIGS["chain" if kind == "eagle" else "eagle3"]
    t_sd, d_sd = _sd(_target()[0]), _eagle_draft_sd(seed, eagle3=kind == "eagle3")

    class TApp(EagleSpecCausalLM):
        def get_state_dict(self):
            return t_sd

        def get_draft_state_dict(self):
            return d_sd

    tcfg, dcfg = _cfgs(False, spec_len, kind == "eagle3")
    tapp = TApp("<t>", tcfg, "<d>", dcfg, model_family=tml, device="cpu")
    _assert_params_equal(tapp.build_params(), japp.params)


FORWARD_CASES = {
    "fc": dict(input_norm=True, final_norm=True),
    "input_norm_skip": dict(input_norm=False, final_norm=True),
    "no_final_norm": dict(input_norm=True, final_norm=False),
    "aux_hidden": None,  # the target, its aux layers
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_eagle_paths_match_jax(case):
    """``causal_lm_forward`` against the JAX package's on the same params and
    inputs: a draft with ``fc`` over ``prev_hidden`` (with its norms), with
    ``input_norm_skip``, without a final norm, and a target's ``aux_hidden``;
    logits, ``hidden`` and ``aux_hidden`` within 1e-5."""
    rng = np.random.default_rng(3)
    B, S = 2, 8
    if case == "aux_hidden":
        tj, tt = _cfgs(True, 3, False)[0], _cfgs(False, 3, False)[0]
        jparams = jml.convert_hf_state_dict(_sd(_target()[0]), tj)
        jarch, tarch = jml.build_arch(tj), tml.build_arch(tt)
        jinv, tinv = jml.build_inv_freq(tj), tml.build_inv_freq(tt)
        kw = dict(aux_hidden_indices=(1, 2))
    else:
        sd = _eagle_draft_sd(7, **FORWARD_CASES[case])
        sd["embed_tokens.weight"] = _sd(_target()[0])["model.embed_tokens.weight"]
        sd["lm_head.weight"] = _sd(_target()[0])["lm_head.weight"]
        dj, dt = _draft_cfgs(False)
        jparams = jle.convert_hf_state_dict(sd, dj)
        jarch, tarch = jle.build_arch(dj), tle.build_arch(dt)
        jinv, tinv = jle.build_inv_freq(dj), tle.build_inv_freq(dt)
        kw = {}
        assert ("norm" in jparams) == FORWARD_CASES[case]["final_norm"]
        assert bool(jparams["layers"]["input_norm_skip"][0]) != FORWARD_CASES[case]["input_norm"]
    tparams = from_jax_params(jax.device_get(jparams))
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    batch = {"input_ids": ids, "position_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
             "last_token_index": np.full((B,), S - 1, np.int32),
             "sampling_params": np.ones((B, 3), np.float32),
             "prev_hidden": rng.standard_normal((B, S, H)).astype(np.float32)}
    jout, _ = jax_forward(jarch, jinv, jparams, jax_init_kv_cache(jarch.kv_cache_spec(B, 16)),
                          {k: jnp.asarray(v) for k, v in batch.items()}, attend_to_cache=False,
                          gather_last_token=False, output_all_logits=True,
                          on_device_sampling=False, output_hidden=True, **kw)
    tout, _ = causal_lm_forward(tarch, torch.as_tensor(tinv, dtype=torch.float32), tparams,
                                init_kv_cache(tarch.kv_cache_spec(B, 16), "cpu"),
                                {k: torch.from_numpy(v) for k, v in batch.items()},
                                attend_to_cache=False, gather_last_token=False,
                                output_logits=True, on_device_sampling=False, output_hidden=True,
                                **kw)
    keys = ("logits", "hidden") + (("aux_hidden",) if kw else ())
    assert set(keys) <= set(tout)
    for key in keys:
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=TOL, rtol=0,
                                   err_msg=key)
    if kw:
        assert tout["aux_hidden"].shape == (B, S, 2 * H)


# ---------------------------------------------------------------------------
# the dynamic tree and the best-path move
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 2, 1), (3, 2, 2), (4, 2, 2), (4, 3, 3)])
def test_dynamic_tree_spec_matches_jax(shape):
    j, t = jtt.DynamicTreeSpec(*shape), ttt.DynamicTreeSpec(*shape)
    assert (t.num_nodes, t.max_depth, t.depth_rows) == (j.num_nodes, j.max_depth, j.depth_rows)
    assert [t.group_rows(g) for g in range(t.steps)] == [j.group_rows(g) for g in range(j.steps)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamic_tree_kv_mask_matches_jax(seed):
    """Random ancestor rows laid into slot space, rows 0 and 1 with trees
    that run past the window (their slots clip to the last one, where the
    rows that land there OR together)."""
    rng = np.random.default_rng(seed)
    B, N1, W = 4, 15, 40
    rows = rng.random((B, 6, N1)) < 0.4
    pos0 = rng.integers(0, W - N1, (B,)).astype(np.int32)
    pos0[0], pos0[1] = W - 4, W - 1
    want = np.asarray(jtt.dynamic_tree_kv_mask(jnp.asarray(rows), jnp.asarray(pos0), W))
    got = ttt.dynamic_tree_kv_mask(torch.from_numpy(rows), torch.from_numpy(pos0), W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, :, W - 1].any()  # the clipped slot is reached


@pytest.mark.parametrize("lines", [False, True])
def test_move_path_rows_is_a_gather_and_a_drop(lines):
    """The shared best-path move (plain version here) against a direct
    gather of the source rows written at the destination slots: sources
    past the cache clip, destinations past it drop, other slots and lines
    stay."""
    g = torch.Generator().manual_seed(0)
    L, Bc, KV, S, D = 2, 3, 2, 20, 8
    cache = {k: torch.randn((L, Bc, KV, S, D), generator=g) for k in ("k", "v")}
    src = torch.tensor([[3, 25, 7], [10, 11, 12]])
    dest = torch.tensor([[1, 2, 3], [18, 19, 20]])
    ln = torch.tensor([2, 0]) if lines else None
    want = {k: v.clone() for k, v in cache.items()}
    for b, line in enumerate(ln.tolist() if lines else [0, 1]):
        for j in range(3):
            if dest[b, j] < S:
                for k in want:
                    want[k][:, line, :, dest[b, j]] = cache[k][:, line, :, min(int(src[b, j]),
                                                                              S - 1)]
    ttt.move_path_rows(cache, src, dest, ln)
    for k in cache:
        assert torch.equal(cache[k], want[k])


# ---------------------------------------------------------------------------
# the windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,B,draft", [(kind, B, draft) for kind in sorted(CONFIGS)
                                          for B, draft in ((1, "random"), (2, "random"),
                                                           (1, "strong"))])
def test_windows_match_jax(kind, B, draft):
    """Chain, EAGLE3 with a reduced vocab, the static tree, and the dynamic
    tree expanding one and two nodes a step, at B 1 and 2 with a random
    draft and at B 1 with the strong pair: tokens equal the JAX package's
    and HF greedy, every window's counts equal the JAX package's, and the
    features buffer and both caches agree within 1e-5 after every window;
    the strong draft is accepted."""
    n = 20 if B == 1 else 12
    jout, tout, jlog, tlog = _generate(kind, B, n, draft=draft)
    np.testing.assert_array_equal(tout, jout)
    _, _, rows = _batch_prompt(B)
    for b, p in enumerate(rows):
        m = len(p)
        np.testing.assert_array_equal(tout[b, :m + n], _hf(tuple(p), n, draft == "strong"))
    _assert_windows_equal(jlog, tlog)
    if draft == "strong":
        assert max(max(c) for c, _ in tlog) > 1, [c for c, _ in tlog]
    _, tapp = _pair(kind, B, draft=draft)
    strategies = set(tapp.models[TAG_FUSED_SPECULATION].attention_strategies[64])
    if kind in ("chain", "eagle3"):
        assert strategies == {"tkg_fused_kernel_stacked", "tkg_two_part_xla"}
    else:
        assert strategies == {"attn_mask_override_xla"}


def test_acceptance_order():
    """By the port's window counts over the same generation (B 1, 20 tokens,
    one draft): the static tree (7 nodes) needs no more windows than the
    chain, and the dynamic tree no more than the static tree — with the
    strong pair at two nodes a step (10 nodes), and with the JAX package's
    own test pair (the random draft of seed 1) at one node a step (6
    nodes). On the strong pair the 6-node dynamic tree needs one window
    more than the static tree, in both packages (test_windows_match_jax)."""
    def windows(kind, draft, **kw):
        return len(_generate(kind, 1, 20, draft=draft, **kw)[3])

    strong = {kind: windows(kind, "strong") for kind in ("tree", "dynamic_m2")}
    strong["chain"] = windows("chain", "strong", draft_seed=CONFIGS["tree"][0])
    assert strong["tree"] <= strong["chain"], strong
    assert strong["dynamic_m2"] <= strong["tree"], strong
    assert strong["tree"] < 20  # the trees accept
    assert windows("dynamic_m1", "random") <= windows("tree", "random")


@pytest.mark.parametrize("kind,case", [("chain", "fill"), ("chain", "small_bucket"),
                                       ("dynamic_m2", "fill")])
def test_window_edge(kind, case):
    """Generating up to the window's limit: filling the cache to its last
    slot, and a token-generation bucket smaller than seq_len. The host's
    clamp of retired tokens and the window's clamp of the retired index
    keep the buffered feature and the next start token in step: tokens,
    counts, caches and features equal the JAX package's window by window."""
    kw = {"token_generation_buckets": (32,)} if case == "small_bucket" else {}
    n = 56 if case == "fill" else 24
    jout, tout, jlog, tlog = _generate(kind, 1, n, **kw)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout[0], _hf(tuple(PROMPT[0]), n)[:tout.shape[1]])
    assert tout.shape[1] >= PROMPT.shape[1] + 24
    _assert_windows_equal(jlog, tlog)


def test_features_buffer_is_live():
    """The features buffer feeds the draft: the context encoding fills it;
    a window after it is zeroed (in place) keeps the target's first token
    but proposes other drafts, and the window refreshes the buffer; the
    whole generate() still equals HF greedy."""
    tapp = _port_app(_pair("chain")[1].params, CONFIGS["chain"][1])
    S = PROMPT.shape[1]
    pos = np.arange(S, dtype=np.int32)[None]
    lti = np.array([S - 1], np.int32)
    drafts = {}
    for zero in (False, True):
        tapp.reset_kv_cache()
        out = tapp.forward(PROMPT.astype(np.int32), pos, last_token_index=lti)
        assert tapp.kv_cache["features"].abs().max() > 0
        t0 = out["tokens"].numpy().astype(np.int32)
        if zero:
            tapp.kv_cache["features"].zero_()
        w = tapp.forward(t0, np.array([[S]], np.int32), last_token_index=np.zeros(1, np.int32))
        drafts[zero] = (w["tokens"].numpy().copy(), tapp.kv_cache["draft"]["k"][:, 0, :, S + 1]
                        .clone())
        assert tapp.kv_cache["features"].abs().max() > 0
    assert drafts[False][0][0, 0] == drafts[True][0][0, 0]
    assert not torch.equal(drafts[False][1], drafts[True][1])
    tapp.reset_kv_cache()
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=12)
    np.testing.assert_array_equal(got[0], _hf(tuple(PROMPT[0]), 12))


def test_int8_draft_and_target():
    """Online int8 weights on the draft (``fc`` included) and the target:
    tokens and window counts equal the JAX package's."""
    jout, tout, jlog, tlog = _generate("chain", 1, 8, quantized=True,
                                       quantization_dtype="int8")
    np.testing.assert_array_equal(tout, jout)
    assert [c for c, _ in tlog] == [c for c, _ in jlog]
    _, tapp = _pair("chain", 1, quantized=True, quantization_dtype="int8")
    assert "qw" in tapp.params["draft"]["fc"]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


REFUSALS = {
    "tree depth": (dict(token_tree_config={"choices": TREE}), 2, ValueError,
                   "must equal the token tree depth"),
    "dynamic steps 0": (dict(token_tree_config={"dynamic": {"steps": 0, "branching_factor": 2}}),
                        3, ValueError, "num_inputs >= 1"),
    "dynamic branching 0": (dict(token_tree_config={"dynamic": {"steps": 3,
                                                                 "branching_factor": 0}}),
                            3, ValueError, "num_inputs >= 1"),
    "dynamic inputs 0": (dict(token_tree_config={"dynamic": {
        "steps": 3, "branching_factor": 2, "num_inputs": 0}}), 3, ValueError, "num_inputs >= 1"),
    "dynamic inputs > branching": (dict(token_tree_config={"dynamic": {
        "steps": 3, "branching_factor": 2, "num_inputs": 3}}), 3, ValueError,
        "cannot exceed branching_factor"),
    "block layout": (dict(is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=16), 3,
                     ValueError, "block KV layout"),
}


@pytest.mark.parametrize("rule", sorted(REFUSALS))
def test_refusals_match_jax(rule):
    """The JAX package's EAGLE refusals, raised by both packages' apps."""
    kw, spec_len, exc, match = REFUSALS[rule]
    for jax_side, App, fam in ((True, JaxEagle, jml), (False, EagleSpecCausalLM, tml)):
        tcfg, dcfg = _cfgs(jax_side, spec_len, False, **kw)
        extra = {} if jax_side else {"device": "cpu"}
        with pytest.raises(exc, match=match):
            App("<t>", tcfg, "<d>", dcfg, model_family=fam, **extra)


def test_quantized_checkpoint_path_refused(tmp_path):
    tcfg, dcfg = _cfgs(False, 3, False, quantized=True, quantized_checkpoints_path=str(tmp_path))
    app = EagleSpecCausalLM("<t>", tcfg, "<d>", dcfg, model_family=tml, device="cpu")
    with pytest.raises(NotImplementedError, match="quantized_checkpoints_path is not supported "
                                                  "with EAGLE"):
        app.build_params()
    jt, jd = _cfgs(True, 3, False, quantized=True, quantized_checkpoints_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="not supported with EAGLE"):
        JaxEagle("<t>", jt, "<d>", jd, model_family=jml).build_params()
