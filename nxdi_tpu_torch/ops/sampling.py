"""Token selection (counterpart of ``nxdi_tpu/ops/sampling.py``): greedy
argmax and the per-row top-k -> temperature -> top-p inverse-CDF sampler over
the ``[top_k, top_p, temperature]`` rows that the static adapter and the
serving engine build through :class:`SamplingParams`.

The JAX package leaves sampling to XLA, so this is plain torch (no kernel).
Where it departs from the JAX package:

- *Random bits.* A draw is a counter-based function of a key tensor: the
  uniform of row ``r`` under key ``(seed, counter)`` is an integer hash of
  ``(seed, counter, r)`` (:func:`uniform_from_key`), not ``jax.random``'s
  threefry and not a stateful ``torch.Generator`` (whose offset a CUDA graph
  replay advances on its own). :func:`next_step_rng` is ``counter + 1``, so
  the host :class:`StepRngSchedule`, a device-resident chain, a K-step
  window and the device loop's ``(seed, counter + t)`` all draw one stream.
- *Injected draws.* :func:`topk_topp_temperature_sample` takes ``u``, so a
  caller can feed it another generator's uniforms (the tests feed JAX's).
- *Ties.* ``jax.lax.top_k`` orders equal values by index, lower first;
  :func:`top_k_lower_index_first` reproduces that order, including which
  tied index makes the cut at rank k (``torch.topk`` of the float values
  promises no order among ties; it runs over keys made unique by the
  index).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.runtime.host_spans import span

NEG_INF = -30000.0


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


class StepRngSchedule:
    """Host-side per-dispatch key data: a fresh ``(seed, counter)`` key every
    step, shared by the static adapter and the serving engine so fixed-seed
    sampled decode cannot diverge between them. Keys are int64 pairs (the
    JAX package's are uint32): only their low 32 bits are hashed."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.counter = 0

    def next(self) -> np.ndarray:
        self.counter += 1
        return np.array([self.seed, self.counter], dtype=np.int64)

    def advance(self, steps: int) -> None:
        """Skip ``steps`` counter values without drawing them: after a device
        loop that ran N iterations (iteration t draws ``(seed, counter +
        t)``), the schedule lands where N chained 1-step dispatches would."""
        self.counter += max(int(steps), 0)


def next_step_rng(rng: torch.Tensor) -> torch.Tensor:
    """The next step's key of a device-resident chain: ``counter + 1``, the
    key the host schedule would hand the next dispatch."""
    return rng + torch.arange(2, dtype=rng.dtype, device=rng.device)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product is split at
    16 bits of c, so no partial product leaves int64 (the same bits on the
    CPU and the card)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xor-shift-multiply, "lowbias32")."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_from_key(rng: torch.Tensor, batch: int) -> torch.Tensor:
    """(..., batch, 1) float32 uniforms in [0, 1) for keys ``rng`` (..., 2) =
    (seed, counter), one per row: the top 24 bits of a hash of (seed,
    counter, row), exact in float32. A pure function of its inputs, so a
    CUDA graph replays it with whatever key its inputs hold."""
    key = rng.to(torch.int64) & _M32
    h = _mix32(_mix32(key[..., 0] ^ 0x9E3779B9) ^ key[..., 1])
    rows = torch.arange(batch, dtype=torch.int64, device=rng.device)
    h = _mix32((_mix32(h[..., None] ^ rows) + 0x632BE5AB) & _M32)
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24)))[..., None]


def top_k_lower_index_first(x: torch.Tensor, k: int):
    """(values, indices), (B, k), sorted by value descending with equal values
    in ascending index order — ``jax.lax.top_k``'s order, including which of
    several entries equal to the k-th value are kept. Each float32 value
    becomes an order-preserving 32-bit integer (negative values' magnitude
    bits flipped), placed above the complement of its index in one int64
    key, so keys are unique and one ``torch.topk`` of them gives that order
    (fixed shapes, no host read: it runs inside a CUDA graph). Only -0.0 and
    +0.0, equal as floats, order apart: +0.0 first."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    keys = torch.topk(ordered * (1 << 32) + (_M32 - idx), k, dim=-1, sorted=True).values
    top_idx = _M32 - (keys & _M32)
    return torch.gather(x.float(), 1, top_idx), top_idx


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's arithmetic: exp(x - max) over its sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def topk_topp_temperature_sample(
    logits: torch.Tensor,  # (B, V)
    sampling_params: torch.Tensor,  # (B, 3) [top_k, top_p, temperature]
    rng: Optional[torch.Tensor] = None,  # (2,) key; None = (0, 0)
    global_topk: int = 256,
    deterministic: bool = False,
    u: Optional[torch.Tensor] = None,  # (B, 1) uniforms; overrides rng
) -> torch.Tensor:
    """Per-row top-k / temperature / top-p sampling at fixed shapes (the JAX
    function's arithmetic, step for step): the ``global_topk`` best logits
    are the candidates; ranks at or past ``top_k`` (when > 0) drop; the
    rest are divided by the temperature; the smallest prefix whose exclusive
    cumulative probability stays under ``top_p`` survives (rank 0 always);
    the token is the first whose CDF reaches the row's uniform."""
    B, V = logits.shape
    k = min(global_topk, V)
    top_vals, top_idx = top_k_lower_index_first(logits.float(), k)
    sp = sampling_params.to(device=logits.device, dtype=torch.float32)
    top_k, top_p = sp[:, 0:1], sp[:, 1:2]
    temperature = sp[:, 2:3].clamp_min(1e-6)
    rank = torch.arange(k, device=logits.device, dtype=torch.float32)[None, :]
    k_mask = torch.where(top_k > 0, rank < top_k, torch.ones_like(rank, dtype=torch.bool))
    vals = torch.where(k_mask, top_vals, torch.full_like(top_vals, NEG_INF)) / temperature
    probs = _softmax(vals)
    p_mask = (torch.cumsum(probs, dim=-1) - probs) < top_p
    p_mask[:, 0] = True
    vals = torch.where(p_mask, vals, torch.full_like(vals, NEG_INF))
    cdf = torch.cumsum(_softmax(vals), dim=-1)
    if u is None:
        if deterministic:
            u = torch.full((B, 1), 0.5, dtype=torch.float32, device=logits.device)
        else:
            if rng is None:
                rng = torch.zeros(2, dtype=torch.int64, device=logits.device)
            u = uniform_from_key(rng, B)
    choice = (cdf < u.to(device=logits.device, dtype=torch.float32)).sum(dim=-1)
    choice = choice.clamp(0, k - 1)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0].to(torch.int32)


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


def sample(logits: torch.Tensor, sampling_params, rng: Optional[torch.Tensor] = None,
           do_sample: bool = False, global_topk: int = 256, deterministic: bool = False,
           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax without ``do_sample``; with it, rows whose top_k is 1 stay exact
    greedy and the others sample."""
    greedy = greedy_sample(logits)
    if not do_sample:
        return greedy
    sp = sampling_params.to(device=logits.device, dtype=torch.float32)
    sampled = topk_topp_temperature_sample(logits, sp, rng, global_topk=global_topk,
                                           deterministic=deterministic, u=u)
    return torch.where(sp[:, 0] == 1, greedy, sampled)


def extract_next_tokens(outputs) -> np.ndarray:
    """(B,) next tokens: the on-device ``tokens`` when the forward sampled,
    else the host-side argmax of the last position's ``logits``."""
    with span("token_fetch"):
        if "tokens" in outputs:
            return outputs["tokens"][:, 0].cpu().numpy()
        logits = outputs["logits"].float().cpu().numpy()
        return logits[:, -1, :].argmax(axis=-1).astype(np.int64)
