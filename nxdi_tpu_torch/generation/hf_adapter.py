"""HuggingFace-style ``generate()`` over a :class:`TorchModelForCausalLM`
(counterpart of ``nxdi_tpu/generation/hf_adapter.py``): one
context-encoding dispatch for the right-padded prompt, then one
token-generation dispatch per new token, with EOS trimming and
``max_new_tokens`` / ``max_length``. Greedy.

Under ``async_mode`` (the app's ``async_supported``) the decode steps run
device-resident, as in the JAX package: each step's inputs are the previous
step's ``next_inputs`` on the device, each step's tokens go to a pinned host
buffer by a non-blocking copy, and the host reads them one step late
(lag-1 EOS), so the fetch of step N-1 overlaps step N.

Not ported yet: sampling, logits processors, multistep and fused
speculation decode loops, and the request telemetry spans.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from nxdi_tpu_torch.ops.sampling import SamplingParams, extract_next_tokens, normalize_eos_ids
from nxdi_tpu_torch.runtime.host_spans import span


def load_pretrained_config(model_path: str):
    """Returns a callable giving the HF ``config.json`` dict."""

    def load():
        with open(os.path.join(model_path, "config.json")) as f:
            return json.load(f)

    return load


class _HostTokens:
    """Step tokens copied off the card as they are made: a ring of pinned
    host buffers, each filled by a non-blocking copy on the dispatch stream
    and marked by an event, so the copy is enqueued before the next step can
    overwrite the graph's output. On the CPU a copy is made at once."""

    DEPTH = 4  # the loop holds at most two steps' tokens unread

    def __init__(self):
        self._ring, self._i = [], 0

    def push(self, tokens: torch.Tensor):
        if tokens.device.type != "cuda":
            return tokens.clone(), None
        if not self._ring:
            self._ring = [(torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True),
                           torch.cuda.Event()) for _ in range(self.DEPTH)]
        host, ev = self._ring[self._i % self.DEPTH]
        self._i += 1
        host.copy_(tokens, non_blocking=True)
        ev.record()
        return host, ev

    @staticmethod
    def get(handle) -> np.ndarray:
        host, ev = handle
        with span("token_fetch"):
            if ev is not None:
                ev.synchronize()
            return host.numpy().copy()


class HuggingFaceGenerationAdapter:
    def __init__(self, app):
        self.app = app
        self.config = app.config
        self.tpu_config = app.tpu_config

    def generate(
        self,
        input_ids: np.ndarray,  # (B, S) right-padded
        attention_mask: Optional[np.ndarray] = None,
        max_new_tokens: Optional[int] = None,
        max_length: Optional[int] = None,
        do_sample: bool = False,
        eos_token_id=None,
        pad_token_id: int = 0,
        logits_processor=None,
        **unused,
    ) -> np.ndarray:
        """Greedy generation. Returns (B, S + T) ids with each row's new
        tokens placed right after its true prompt length."""
        if logits_processor:
            raise NotImplementedError("logits_processor is not ported yet")
        input_ids = np.asarray(input_ids)
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = (input_ids != pad_token_id).astype(np.int32)
        lengths = np.maximum(np.asarray(attention_mask).sum(axis=1).astype(np.int32), 1)
        if max_length is None:
            max_length = (
                int(lengths.max()) + max_new_tokens
                if max_new_tokens is not None
                else self.tpu_config.seq_len
            )
        if int(lengths.max()) > self.tpu_config.max_context_length:
            raise ValueError(
                f"prompt length {int(lengths.max())} exceeds max_context_length "
                f"{self.tpu_config.max_context_length} (largest context-encoding bucket)"
            )
        max_length = min(max_length, self.tpu_config.seq_len)
        n_new = max_length - int(lengths.max())
        if n_new <= 0:
            return input_ids
        eos_ids = normalize_eos_ids(eos_token_id)
        sampling_params = SamplingParams(max_new_tokens=n_new, do_sample=do_sample).tensor(B)

        position_ids = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        outputs = self.app.forward(
            input_ids.astype(np.int32), position_ids,
            last_token_index=lengths - 1, sampling_params=sampling_params,
        )
        next_tokens = extract_next_tokens(outputs)
        generated: List[np.ndarray] = [next_tokens]
        finished = np.isin(next_tokens, eos_ids)
        if self.app.async_supported and "next_inputs" in outputs and not finished.all():
            gen = self._device_decode_loop(outputs["next_inputs"], next_tokens, lengths, n_new,
                                           eos_ids, pad_token_id, B)
            return self._assemble(input_ids, gen, lengths, pad_token_id)
        cur_pos = lengths.copy()  # position of the next token to write
        for _ in range(n_new - 1):
            if finished.all():
                break
            outputs = self.app.forward(
                next_tokens[:, None].astype(np.int32), cur_pos[:, None].astype(np.int32),
                last_token_index=np.zeros((B,), dtype=np.int32),
                sampling_params=sampling_params,
            )
            next_tokens = np.where(finished, pad_token_id, extract_next_tokens(outputs))
            generated.append(next_tokens)
            finished |= np.isin(next_tokens, eos_ids)
            cur_pos = cur_pos + 1
        return self._assemble(input_ids, np.stack(generated, axis=1), lengths, pad_token_id)

    def _device_decode_loop(self, next_inputs, first_tokens, lengths, n_new, eos_ids,
                            pad_token_id, B) -> np.ndarray:
        """Device-resident decode: each step's outputs feed the next step with
        no host round trip; EOS is checked one step late, so the fetch of
        step N-1 overlaps step N (the JAX package's ``_device_decode_loop``)."""
        host = _HostTokens()
        token_stream = [first_tokens]  # step 0 already on the host
        pending = []  # handles of tokens not read yet
        finished = np.isin(first_tokens, eos_ids)
        max_len0 = int(lengths.max())
        for step in range(1, n_new):
            # query position this step = lengths + step - 1 -> window = max + 1
            outputs = self.app.token_gen_device(next_inputs, max_len0 + step)
            next_inputs = outputs["next_inputs"]
            pending.append(host.push(outputs["tokens"]))
            if len(pending) >= 2:  # lag-1 EOS: the previous step's tokens
                prev = host.get(pending.pop(0))[:B, 0]
                token_stream.append(prev)
                finished |= np.isin(prev, eos_ids)
                if finished.all():
                    break
        for handle in pending[-1:]:
            token_stream.append(host.get(handle)[:B, 0])
        gen = np.stack(token_stream[:n_new], axis=1)
        return self._mask_and_trim_eos(gen, eos_ids, pad_token_id)

    @staticmethod
    def _mask_and_trim_eos(gen, eos_ids, pad_token_id) -> np.ndarray:
        """Pad-mask tokens sampled after each row's EOS, then trim the
        pipeline's overshoot past the all-finished point, so the output
        length matches the sync loop exactly."""
        if not eos_ids:
            return gen
        first_eos = []
        for b in range(gen.shape[0]):
            hits = np.flatnonzero(np.isin(gen[b], eos_ids))
            if hits.size:
                gen[b, hits[0] + 1:] = pad_token_id
            first_eos.append(hits[0] if hits.size else gen.shape[1] - 1)
        return gen[:, : max(first_eos) + 1]

    @staticmethod
    def _assemble(input_ids, gen, lengths, pad_token_id) -> np.ndarray:
        B, S = input_ids.shape
        T = gen.shape[1]
        out = np.full((B, S + T), pad_token_id, dtype=input_ids.dtype)
        out[:, :S] = input_ids
        for b in range(B):
            out[b, lengths[b]: lengths[b] + T] = gen[b]
        return out
