"""Bucket ladders — the port's copy of the CTE/TKG/prefix-prefill/mixed and
multistep/device-loop parts of ``nxdi_tpu/runtime/autobucketing.py``: powers of two from the minimum to the
maximum with the true maximum as the last rung, and capped chunk ladders for
chunked prefill. The host pads each dispatch to the smallest rung that fits,
exactly as the JAX package does, so both packages pick the same bucket for
the same request.
"""

from __future__ import annotations

from math import ceil, log2
from typing import List, Sequence

BUCKET_SELECTION_STRATEGIES = {"max", "first_fit", "second_fit"}


def _pow2_at_least(n: int) -> int:
    return 1 << int(ceil(log2(n)))


def generate_buckets(min_length: int, max_length: int) -> List[int]:
    if min_length == max_length:
        return [max_length]
    min_bound = int(log2(min_length))
    max_bound = round(log2(max_length))
    return [2**i for i in range(min_bound, max_bound)] + [max_length]


def generate_buckets_on_chunk_size(q_tile_size: int, max_context_len: int) -> List[int]:
    """At most 3 rungs, multiples of the q tile: the first, the median and
    the last of the tile multiples up to ``max_context_len``."""
    if max_context_len < q_tile_size:
        return [q_tile_size]
    num_q_tiles = ceil(max_context_len / q_tile_size)
    all_buckets = [b * q_tile_size for b in range(1, num_q_tiles + 1)]
    left, right = 0, len(all_buckets) - 1
    median = right // 2
    out = [all_buckets[left]]
    if median > left:
        out.append(all_buckets[median])
    if right > median:
        out.append(all_buckets[right])
    return out


def context_encoding_buckets(config) -> List[int]:
    tc = config.tpu_config
    if tc.context_encoding_buckets:
        return sorted(tc.context_encoding_buckets)
    if not tc.enable_bucketing:
        return [tc.max_context_length]
    if tc.long_context_mode:
        lo = _pow2_at_least(max(128, tc.max_context_length // 8))
        return generate_buckets(min(lo, tc.max_context_length), tc.max_context_length)
    return generate_buckets(min(128, tc.max_context_length), tc.max_context_length)


def token_generation_buckets(config) -> List[int]:
    tc = config.tpu_config
    if tc.is_block_kv_layout:
        # the block-table width is the decode window: every rung would run
        # the same shapes (the pool has no contiguous window to slice)
        return [tc.seq_len]
    if tc.token_generation_buckets:
        return sorted(tc.token_generation_buckets)
    if not tc.enable_bucketing:
        return [tc.seq_len]
    if tc.long_context_mode:
        lo = _pow2_at_least(max(128, tc.seq_len // 8))
        return generate_buckets(min(lo, tc.seq_len), tc.seq_len)
    return generate_buckets(min(128, tc.seq_len), tc.seq_len)


def prefix_prefill_buckets(config) -> List[int]:
    """Active-token ladder of the prefix-prefill submodel (prefix-cached and
    chunked prefill): the chunk ladder under ``chunked_prefill_config``,
    else the CTE ladder (the prefix needs no rung: the block table is
    fixed-width)."""
    tc = config.tpu_config
    if tc.chunked_prefill_config is not None:
        return generate_buckets_on_chunk_size(
            tc.chunked_prefill_config.kernel_q_tile_size, tc.max_context_length
        )
    return context_encoding_buckets(config)


def mixed_token_buckets(config) -> List[int]:
    """Total-packed-token ladder of the ``mixed_model`` submodel (the
    one-dispatch prefill+decode serving step): rungs count tokens across the
    whole packed batch. The top rung holds the largest step the scheduler can
    pack — one prefill contribution of ``max_context_length`` tokens plus one
    decode token for every slot — and the ladder bottoms out at 2, so a
    decode-only step of a few live slots does not pad to a 16- or 128-token
    program."""
    tc = config.tpu_config
    top = tc.max_context_length + tc.tkg_batch_size
    return generate_buckets(min(2, top), top)


def multistep_step_ladder(max_steps: int) -> List[int]:
    """Step rungs of the multistep submodel: powers of two from 2 with K as
    the last rung (K 8 -> [2, 4, 8]); the plain token-generation submodel is
    the 1-step program. The dispatcher picks the smallest rung covering the
    remaining budget."""
    if max_steps <= 2:
        return [max(2, max_steps)]
    return generate_buckets(2, max_steps)


def device_loop_budget_ladder(max_budget: int) -> List[int]:
    """Token-buffer rungs of the device loop: powers of two from 4 with the
    largest per-launch budget last (24 -> [4, 8, 16, 24]). A rung bounds the
    loop, it does not schedule it: the loop exits once every row is done."""
    if max_budget <= 4:
        return [max(1, max_budget)]
    return generate_buckets(4, max_budget)


def get_target_steps(remaining: int, ladder: Sequence[int]) -> int:
    """Smallest rung covering ``remaining`` tokens, else the largest."""
    fits = [s for s in sorted(ladder) if s >= remaining]
    return fits[0] if fits else max(ladder)


def get_target_bucket(length: int, buckets: Sequence[int], strategy: str = "first_fit") -> int:
    if strategy not in BUCKET_SELECTION_STRATEGIES:
        raise ValueError(f"Unknown bucket strategy {strategy}")
    if strategy == "max":
        return buckets[-1]
    fits = [b for b in sorted(buckets) if b >= length]
    if not fits:
        raise ValueError(f"Input length {length} exceeds the largest bucket {max(buckets)}")
    if strategy == "second_fit" and len(fits) > 1:
        return fits[1]
    return fits[0]
