"""Token selection (counterpart of ``nxdi_tpu/ops/sampling.py``).

The port decodes greedily. The sampling-params tensor layout
([top_k, top_p, temperature] per batch line) and the request-level
:class:`SamplingParams` are kept so the static adapter and the serving
engine build the same rows as in the JAX package; stochastic sampling
(top-k/top-p/temperature with a ``torch.Generator``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.runtime.host_spans import span

NEG_INF = -30000.0

SAMPLING_NOT_PORTED = (
    "do_sample=True: stochastic sampling is not ported yet; use greedy decoding"
)


def prepare_sampling_params(
    batch_size: int,
    top_k: Sequence[int] = (1,),
    top_p: Sequence[float] = (1.0,),
    temperature: Sequence[float] = (1.0,),
) -> np.ndarray:
    """(B, 3) float32 [top_k, top_p, temperature] per batch line."""

    def bcast(x, name):
        arr = np.asarray(x, dtype=np.float32).reshape(-1)
        if arr.size == 1:
            arr = np.full((batch_size,), arr[0], dtype=np.float32)
        if arr.size != batch_size:
            raise ValueError(f"{name} must have 1 or batch_size entries, got {arr.size}")
        return arr

    return np.stack(
        [bcast(top_k, "top_k"), bcast(top_p, "top_p"), bcast(temperature, "temperature")],
        axis=1,
    )


def normalize_eos_ids(eos_token_id) -> List[int]:
    """int | list | array | None -> list of int eos ids."""
    if eos_token_id is None:
        return []
    return [int(e) for e in np.atleast_1d(eos_token_id).astype(np.int64)]


@dataclass
class SamplingParams:
    """Per-request sampling knobs; ``do_sample=False`` coerces the row to
    greedy (top_k=1). ``n`` continuations of one prompt are generated by the
    serving engine as sibling requests (host-side only, never part of the
    sampling row)."""

    max_new_tokens: int = 64
    eos_token_ids: Tuple[int, ...] = ()
    do_sample: bool = False
    top_k: int = 1
    top_p: float = 1.0
    temperature: float = 1.0
    n: int = 1

    def __post_init__(self):
        self.eos_token_ids = tuple(normalize_eos_ids(self.eos_token_ids))
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.n < 1:
            raise ValueError("n must be >= 1")
        if self.do_sample:
            raise NotImplementedError(SAMPLING_NOT_PORTED)

    def row(self) -> Tuple[float, float, float]:
        return (float(self.top_k if self.do_sample else 1), float(self.top_p),
                float(self.temperature))

    def tensor(self, batch_size: int) -> np.ndarray:
        k, p, t = self.row()
        return prepare_sampling_params(batch_size, top_k=[k], top_p=[p], temperature=[t])

    @staticmethod
    def rows_tensor(params: Sequence["SamplingParams"]) -> np.ndarray:
        """(B, 3) tensor with one row per request — the serving engine's
        batched decode dispatch."""
        rows = [p.row() for p in params]
        return prepare_sampling_params(
            len(rows), top_k=[r[0] for r in rows], top_p=[r[1] for r in rows],
            temperature=[r[2] for r in rows],
        )


def mask_padded_logits(logits: torch.Tensor, pad_size: int) -> torch.Tensor:
    """Mask the vocab-padding tail added so the vocab divides tp."""
    if pad_size == 0:
        return logits
    vocab = logits.shape[-1]
    idx = torch.arange(vocab, device=logits.device)
    return torch.where(idx >= vocab - pad_size, torch.full_like(logits, NEG_INF), logits)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) -> (...) argmax token ids (int32). Ties take the first index,
    as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, sampling_params, do_sample: bool = False) -> torch.Tensor:
    if do_sample:
        raise NotImplementedError(SAMPLING_NOT_PORTED)
    return greedy_sample(logits)


def extract_next_tokens(outputs) -> np.ndarray:
    """(B,) next tokens: the on-device ``tokens`` when the forward sampled,
    else the host-side argmax of the last position's ``logits``."""
    with span("token_fetch"):
        if "tokens" in outputs:
            return outputs["tokens"][:, 0].cpu().numpy()
        logits = outputs["logits"].float().cpu().numpy()
        return logits[:, -1, :].argmax(axis=-1).astype(np.int64)
