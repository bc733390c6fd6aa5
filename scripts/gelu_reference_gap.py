#!/usr/bin/env python
"""How far the JAX package's GELU families sit from HF, beside the port.

HF's ``ACT2FN["gelu"]`` is the exact (erf) GELU; the JAX package's
``ACT_FNS["gelu"]`` is ``jax.nn.gelu``'s default, the tanh approximation,
and Falcon, GPT-NeoX, BioGPT and XGLM hand their config's ``"gelu"`` to it.
For each of those families, a tiny random HF model (2 layers, hidden 64, the
JAX package's own test configs) is loaded into the JAX package's app and,
on the JAX app's params, into the port's app (which maps ``"gelu"`` to the
exact GELU). The script prints the largest |logit - HF logit| of a
12-token prompt's last position for each, in float32 on the CPU, at HF's
initial weights and with every projection scaled by 10 (larger activations,
where the two GELUs part more).

    JAX_PLATFORMS=cpu python scripts/gelu_reference_gap.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=256, max_position_embeddings=256,
            tie_word_embeddings=False)
CASES = {
    "falcon": ("FalconForCausalLM", dict(multi_query=True, parallel_attn=True,
                                         new_decoder_architecture=False, bias=False,
                                         alibi=False, tie_word_embeddings=True)),
    "gpt_neox": ("GPTNeoXForCausalLM", dict(rotary_pct=0.25, use_parallel_residual=True,
                                            hidden_act="gelu", attention_bias=True)),
    "biogpt": ("BioGptForCausalLM", dict(scale_embedding=True, hidden_act="gelu",
                                         tie_word_embeddings=True)),
    "xglm": ("XGLMForCausalLM", dict(ffn_dim=128, activation_function="gelu",
                                     tie_word_embeddings=True)),
}
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4]], dtype=np.int64)


def apps(model_type, cfg, sd):
    """(the JAX package's app on the HF checkpoint, the port's app on the JAX
    app's params), float32 on the CPU, attention kernels off."""
    import jax

    from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
    from nxdi_tpu.config import TpuConfig
    from nxdi_tpu.models import registry as jreg
    from nxdi_tpu.runtime.application import TpuModelForCausalLM
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import registry as treg
    from nxdi_tpu_torch.models.convert import from_jax_params
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    tc = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
              skip_warmup=True, output_logits=True)
    jfam, jcls = jreg.get_family(model_type)

    class JaxApp(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    japp = JaxApp("<memory>", jcls(TpuConfig(on_device_sampling_config=JaxODSC(), **tc),
                                   load_config=lambda: dict(cfg)), model_family=jfam)
    japp.load()
    params = from_jax_params(jax.device_get(japp.params))
    tfam, tcls = treg.get_family(model_type)

    class PortApp(TorchModelForCausalLM):
        def build_params(self):
            return params

    tapp = PortApp("<memory>", tcls(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(),
                                                **tc), load_config=lambda: dict(cfg)),
                   model_family=tfam, device="cpu")
    tapp.load()
    return japp, tapp


def last_logits(app):
    import jax

    S = PROMPT.shape[1]
    out = app.forward(PROMPT.astype(np.int32), np.arange(S, dtype=np.int32)[None],
                      last_token_index=np.array([S - 1], np.int32))
    lg = out["logits"]
    lg = lg.numpy() if isinstance(lg, torch.Tensor) else np.asarray(jax.device_get(lg))
    return lg[:, -1]


def main() -> int:
    import transformers

    for scale in (1.0, 10.0):
        for model_type, (cls_name, over) in CASES.items():
            torch.manual_seed(0)
            cfg_cls = getattr(transformers, cls_name.replace("ForCausalLM", "Config"))
            model = getattr(transformers, cls_name)(cfg_cls(**{**TINY, **over})).eval()
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if p.ndim == 2 and "embed" not in name:
                        p.mul_(scale)
                hf = model(torch.from_numpy(PROMPT)).logits[:, -1].numpy()
            sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
            japp, tapp = apps(model_type, model.config.to_dict(), sd)
            print(f"projections x {scale:g}, {model_type}: JAX package - HF "
                  f"{np.abs(last_logits(japp) - hf).max():.3g}, port - HF "
                  f"{np.abs(last_logits(tapp) - hf).max():.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
