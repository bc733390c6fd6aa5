"""KV handoff for prefill/decode disaggregation — the port's copy of
``nxdi_tpu/serving/handoff.py``, same payload and same wire.

A prefill-role engine (``TorchConfig(role="prefill")``) prefills a request,
samples its FIRST token, then parks it: the block chain stays in its pool
until the chain has been imported elsewhere and acknowledged. The payload
holds what a decode-role engine needs to continue the request as if it had
prefilled it:

- the prompt and the tokens already emitted (normally the first one),
- the committed KV positions (= the prompt length: the last emitted token's
  KV is written by the importer's first decode step),
- the chain's K/V rows (``kvcache.export_kv_blocks``) in the pool's store
  dtype, one-byte stores included,
- the sampling params and the exporter's key-schedule cursor,
- the exporting pool's block size and store dtype, which the importer checks
  before it touches its pool.

The wire (``to_wire`` / ``from_wire``, version 1) is the JAX package's: a
JSON-safe dict whose K/V arrays are base64 of their raw bytes with the
dtype's name (``bfloat16``, ``float8_e4m3fn``, ``float8_e5m2``, ``int8``,
``float32``), so a payload written by either package decodes in the other
to the same arrays. Here the arrays are CPU tensors: the port reads and
writes the bytes through ``uint8`` views, without numpy's extension dtypes.

Import failures raise :class:`HandoffCapacityError` (transient: try another
replica) or ``ValueError`` (a format mismatch).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from nxdi_tpu_torch.ops.sampling import SamplingParams

__all__ = [
    "HANDOFF_WIRE_VERSION",
    "HandoffCapacityError",
    "HandoffPayload",
]

#: wire schema version; ``from_wire`` rejects anything it does not speak
HANDOFF_WIRE_VERSION = 1

#: the sampling knobs that ride the wire
SAMPLING_WIRE_KEYS = (
    "max_new_tokens",
    "eos_token_ids",
    "do_sample",
    "top_k",
    "top_p",
    "temperature",
)

# the wire's dtype names (numpy's, and those of numpy's extension dtypes for
# bfloat16 and fp8)
_WIRE_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
}


class HandoffCapacityError(RuntimeError):
    """The receiving engine has no slot or pool room for the imported chain
    right now — transient: another decode replica may take it while the
    prefill side keeps the chain."""


def wire_dtype_name(dtype: torch.dtype) -> str:
    """The wire's name of a torch dtype."""
    for name, dt in _WIRE_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"dtype {dtype} has no handoff wire name")


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _WIRE_DTYPES:
        raise ValueError(f"unsupported handoff dtype {name!r}")
    return _WIRE_DTYPES[name]


def _encode_array(t: torch.Tensor) -> dict:
    t = t.detach().to("cpu").contiguous()
    return {
        "shape": list(t.shape),
        "dtype": wire_dtype_name(t.dtype),
        "data": base64.b64encode(t.view(torch.uint8).numpy().tobytes()).decode("ascii"),
    }


def _decode_array(obj: dict) -> torch.Tensor:
    raw = np.frombuffer(base64.b64decode(obj["data"]), dtype=np.uint8).copy()
    return torch.from_numpy(raw).view(_torch_dtype(obj["dtype"])).reshape(obj["shape"])


@dataclass
class HandoffPayload:
    """One parked prefill, ready to continue on a decode engine."""

    request_id: int
    prompt: List[int]
    #: tokens the prefill side already emitted (and streamed): the decode
    #: side seeds the request with them without streaming them again
    first_tokens: List[int]
    #: KV positions in ``kv`` (= len(prompt))
    committed: int
    sampling: dict
    rng_seed: int
    rng_counter: int
    block_size: int
    #: the exporting pool's store dtype, by its wire name
    dtype: str
    #: CPU K/V rows from :func:`nxdi_tpu_torch.kvcache.kv_cache.export_kv_blocks`
    kv: Dict[str, torch.Tensor] = field(repr=False, default_factory=dict)
    session_id: Optional[str] = None
    #: distributed-trace context of the exporting side (optional on the wire)
    trace: Optional[dict] = None
    version: int = HANDOFF_WIRE_VERSION

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.kv.values()))

    def sampling_params(self) -> SamplingParams:
        return SamplingParams(**{
            k: (tuple(v) if k == "eos_token_ids" else v)
            for k, v in self.sampling.items()
            if k in SAMPLING_WIRE_KEYS
        })

    @staticmethod
    def sampling_wire(params: SamplingParams) -> dict:
        return {
            k: (list(getattr(params, k)) if k == "eos_token_ids" else getattr(params, k))
            for k in SAMPLING_WIRE_KEYS
        }

    def to_wire(self) -> dict:
        """JSON-safe dict (K/V rows base64-encoded)."""
        return {
            "version": self.version,
            "request_id": self.request_id,
            "session_id": self.session_id,
            "trace": None if self.trace is None else dict(self.trace),
            "prompt": list(self.prompt),
            "first_tokens": list(self.first_tokens),
            "committed": self.committed,
            "sampling": dict(self.sampling),
            "rng": {"seed": self.rng_seed, "counter": self.rng_counter},
            "block_size": self.block_size,
            "dtype": self.dtype,
            "k": _encode_array(self.kv["k"]),
            "v": _encode_array(self.kv["v"]),
        }

    @classmethod
    def from_wire(cls, obj: dict) -> "HandoffPayload":
        version = obj.get("version")
        if version != HANDOFF_WIRE_VERSION:
            raise ValueError(
                f"unsupported handoff wire version {version!r} "
                f"(this build speaks {HANDOFF_WIRE_VERSION})"
            )
        return cls(
            request_id=int(obj["request_id"]),
            prompt=[int(t) for t in obj["prompt"]],
            first_tokens=[int(t) for t in obj["first_tokens"]],
            committed=int(obj["committed"]),
            sampling=dict(obj["sampling"]),
            rng_seed=int(obj["rng"]["seed"]),
            rng_counter=int(obj["rng"]["counter"]),
            block_size=int(obj["block_size"]),
            dtype=str(obj["dtype"]),
            kv={"k": _decode_array(obj["k"]), "v": _decode_array(obj["v"])},
            session_id=obj.get("session_id"),
            trace=obj.get("trace") if isinstance(obj.get("trace"), dict) else None,
            version=int(version),
        )

    def validate_against(self, block_size: int, store_dtype: torch.dtype) -> None:
        """Receiver-side format gate, before any allocation: block geometry
        and store dtype must agree (the per-array layer/head/head_dim and
        length checks happen again inside ``import_kv_blocks``)."""
        if self.block_size != block_size:
            raise ValueError(
                f"handoff block_size mismatch: payload {self.block_size} vs "
                f"receiver pool {block_size}"
            )
        if self.dtype not in _WIRE_DTYPES or _torch_dtype(self.dtype) != store_dtype:
            raise ValueError(
                f"handoff dtype mismatch: payload {self.dtype!r} vs receiver "
                f"cache {wire_dtype_name(store_dtype)}"
            )
        if self.committed < 1 or not self.prompt or not self.first_tokens:
            raise ValueError(
                "handoff payload incomplete: needs a prompt, at least one "
                "emitted token and committed >= 1"
            )
        n_blocks = -(-self.committed // self.block_size)
        rows = self.kv["k"].shape[1] if self.kv else 0
        if rows != n_blocks * self.block_size:
            raise ValueError(
                f"handoff chain length mismatch: committed={self.committed} "
                f"needs {n_blocks} blocks x {self.block_size} slots but the "
                f"payload carries {rows} rows"
            )
