"""The port's package boundary: no JAX and nothing of the JAX package, and
entry points that default to the card."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nxdi_tpu_torch")

# `import jax`, `from jax...`, `import nxdi_tpu`, `from nxdi_tpu.x import`,
# `import nxdi_tpu.x` — but not the port's own name, nxdi_tpu_torch
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|nxdi_tpu(?:\.|\s|$))", re.MULTILINE
)


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter whose jax and nxdi_tpu imports fail, every
    module of the port imports."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["nxdi_tpu"] = None
        import nxdi_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(nxdi_tpu_torch.__path__, "nxdi_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("text,bad", [
    ("import jax\n", True),
    ("from jax import numpy\n", True),
    ("import nxdi_tpu\n", True),
    ("from nxdi_tpu.ops import rope\n", True),
    ("    import nxdi_tpu.config as c\n", True),
    ("from nxdi_tpu_torch.ops import rope\n", False),
    ("import nxdi_tpu_torch\n", False),
    ("import jaxtyping_free_name_is_fine\n", False),
])
def test_forbidden_pattern(text, bad):
    assert bool(FORBIDDEN.search(text)) is bad


def test_source_scan_finds_no_jax_import():
    offenders = [p for p in _sources() if FORBIDDEN.search(open(p).read())]
    assert offenders == []


def test_app_defaults_to_the_card():
    from nxdi_tpu_torch.config import TorchConfig
    from nxdi_tpu_torch.models.llama import modeling_llama as ml
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM, resolve_device

    cfg = ml.LlamaInferenceConfig(
        TorchConfig(seq_len=16), hidden_size=16, intermediate_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, vocab_size=32, rms_norm_eps=1e-5,
    )
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchModelForCausalLM("<none>", cfg, model_family=ml)
    assert TorchModelForCausalLM("<none>", cfg, model_family=ml, device="cpu").device.type == "cpu"


def test_helpers_default_to_the_card():
    """``init_kv_cache`` and ``dense.random_params`` put their tensors on the
    card unless the CPU is asked for: without a GPU the default raises as
    ``resolve_device`` does."""
    from nxdi_tpu_torch.config import TorchConfig
    from nxdi_tpu_torch.kvcache.kv_cache import KVCacheSpec, init_kv_cache
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models.llama import modeling_llama as ml

    cfg = ml.LlamaInferenceConfig(
        TorchConfig(seq_len=16), hidden_size=16, intermediate_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, vocab_size=32, rms_norm_eps=1e-5,
    )
    arch = ml.build_arch(cfg)
    spec = KVCacheSpec(num_layers=1, batch_size=1, num_kv_heads=1, max_len=8, head_dim=8)
    if torch.cuda.is_available():
        assert init_kv_cache(spec)["k"].is_cuda
        assert dense.random_params(arch)["norm"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_cache(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dense.random_params(arch)
    assert init_kv_cache(spec, device="cpu")["k"].device.type == "cpu"
    assert dense.random_params(arch, device="cpu")["norm"].device.type == "cpu"
