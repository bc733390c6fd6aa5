"""Hand-written CUDA kernels and their plain PyTorch versions."""

from nxdi_tpu_torch.ops.kernels.flash_attention import (  # noqa: F401
    flash_attention_decode_fused,
    flash_attention_decode_fused_stacked,
    flash_attention_prefill,
)
from nxdi_tpu_torch.ops.kernels.kv_commit import kv_commit_rows  # noqa: F401


def launch_counters():
    """Every kernel wrapper that counts its launches in ``.launches`` (the
    stacked entries count on their plain entry's wrapper)."""
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    return (fa.flash_attention_prefill, fa.flash_attention_decode_fused,
            fa.flash_attention_decode, fa.paged_attention_decode, fa.paged_attention_prefill,
            rpa.ragged_paged_attention, kv_commit_rows, fp.qkv_matmul, fp.fused_mlp)
