"""HuggingFace-style ``generate()`` over a :class:`TorchModelForCausalLM`
(counterpart of ``nxdi_tpu/generation/hf_adapter.py``): one
context-encoding dispatch for the right-padded prompt, then one
token-generation dispatch per new token, with EOS trimming and
``max_new_tokens`` / ``max_length``. Greedy, or sampled (``do_sample``,
``top_k``, ``top_p``, ``temperature``, ``seed``; an HF ``generation_config``
supplies what is unset) on the device with one key per dispatch from a
:class:`StepRngSchedule`. ``logits_processor`` runs HF-style processors on
the host over the emitted logits, then the same sampler.

Under ``async_mode`` (the app's ``async_supported``) the decode steps run
device-resident, as in the JAX package: each step's inputs are the previous
step's ``next_inputs`` on the device, each step's tokens go to a pinned host
buffer by a non-blocking copy, and the host reads them one step late
(lag-1 EOS), so the fetch of step N-1 overlaps step N. With the
``tkg_multistep`` submodel the decode strides K tokens per dispatch the same
way, window after window.

``padding_side`` (the config key, "right" or "left") is the tokenizer's
setting; as in the JAX package it is only validated: ``generate()`` takes
right-padded ids (true lengths from ``attention_mask``) either way, and an
extra ``padding_side`` argument is accepted and ignored.

Speculation apps (``is_fused_spec``: the fused pair, the standard pair and
Medusa, ``nxdi_tpu_torch/speculation/``) decode window by window
(:meth:`HuggingFaceGenerationAdapter._fused_spec_decode`): each dispatch
retires ``counts[b]`` tokens of row b, rows advance at their own positions,
and tokens past the KV window limit are discarded. Greedy only (a
``do_sample`` request is warned about and decoded greedily, as in the JAX
package); a ``logits_processor`` is refused. Windows and emitted tokens are
counted on the app (``spec_windows``, ``spec_accepted_tokens``).

Multi-adapter LoRA: ``adapter_ids`` (B,) picks each row's adapter slot
(``app.lora_adapter_id(name)``; 0 or omitted: the base model) for the context
encoding and every decode step of the sync loop. The config refuses LoRA
with ``async_mode``, K-step windows, the device loop and speculation (the
JAX package's rules), so those paths never see adapters.

Not ported yet: the request telemetry spans.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from nxdi_tpu_torch.ops import sampling as sampling_ops
from nxdi_tpu_torch.ops.sampling import (
    SamplingParams,
    StepRngSchedule,
    extract_next_tokens,
    normalize_eos_ids,
)
from nxdi_tpu_torch.runtime.host_spans import span
from nxdi_tpu_torch.runtime.model_wrapper import (
    MULTISTEP_EOS_SLOTS,
    TAG_TOKEN_GENERATION_MULTISTEP,
    decode_window_limit,
)

logger = logging.getLogger("nxdi_tpu_torch")


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
        self._rings, self._i = {}, 0  # one ring per token shape (K-step rungs differ)

    def push(self, tokens: torch.Tensor):
        if tokens.device.type != "cuda":
            return tokens.clone(), None
        ring = self._rings.get(tuple(tokens.shape))
        if ring is None:
            ring = self._rings[tuple(tokens.shape)] = [
                (torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True),
                 torch.cuda.Event()) for _ in range(self.DEPTH)]
        host, ev = ring[self._i % self.DEPTH]
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
        top_k: int = 1,
        top_p: float = 1.0,
        temperature: float = 1.0,
        eos_token_id=None,
        pad_token_id: int = 0,
        seed: int = 0,
        adapter_ids: Optional[np.ndarray] = None,
        logits_processor=None,
        generation_config=None,
        **unused,
    ) -> np.ndarray:
        """Returns (B, S + T) ids with each row's new tokens placed right
        after its true prompt length."""
        if generation_config is not None:
            # HF GenerationConfig values are defaults for unset arguments; its
            # default max_length (20) counts only without max_new_tokens
            gc = generation_config
            if max_new_tokens is None:
                max_new_tokens = getattr(gc, "max_new_tokens", None)
            if max_length is None and max_new_tokens is None:
                max_length = getattr(gc, "max_length", None)
            do_sample = do_sample or bool(getattr(gc, "do_sample", False))
            if top_k == 1 and getattr(gc, "top_k", None):
                top_k = gc.top_k
            if top_p == 1.0 and getattr(gc, "top_p", None):
                top_p = gc.top_p
            if temperature == 1.0 and getattr(gc, "temperature", None):
                temperature = gc.temperature
            if eos_token_id is None:
                eos_token_id = getattr(gc, "eos_token_id", None)
            if pad_token_id == 0 and getattr(gc, "pad_token_id", None) is not None:
                pad_token_id = gc.pad_token_id
        if logits_processor and not self.tpu_config.output_logits:
            raise ValueError("logits_processor needs host-visible logits: build the app "
                             "with output_logits=True")
        if logits_processor and getattr(self.app, "is_fused_spec", False):
            raise ValueError("logits_processor is incompatible with fused speculation "
                             "(tokens are selected inside the compiled window)")
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
        odsc = self.tpu_config.on_device_sampling_config
        if do_sample and not (odsc and odsc.do_sample) and not logits_processor:
            logger.warning("generate(do_sample=True) on an app built without on-device "
                           "sampling (OnDeviceSamplingConfig(do_sample=True)): greedy")
        self._rng = StepRngSchedule(seed)
        sampling_params = SamplingParams(
            max_new_tokens=n_new, do_sample=do_sample, top_k=top_k, top_p=top_p,
            temperature=temperature,
        ).tensor(B)
        select = dict(do_sample=do_sample, top_k=top_k, top_p=top_p, temperature=temperature,
                      lengths=lengths, prompt_width=S, pad_token_id=pad_token_id)

        lora_kwargs = {}
        if adapter_ids is not None:
            lora_kwargs["adapter_ids"] = np.asarray(adapter_ids, dtype=np.int32)

        position_ids = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        outputs = self.app.forward(
            input_ids.astype(np.int32), position_ids,
            last_token_index=lengths - 1, sampling_params=sampling_params,
            rng=self._rng.next(), **lora_kwargs,
        )
        running = input_ids.copy() if logits_processor else None
        if logits_processor:
            next_tokens = self._host_select(outputs, running, logits_processor, **select)
            running = np.concatenate([running, next_tokens[:, None]], axis=1)
        else:
            next_tokens = extract_next_tokens(outputs)
        generated: List[np.ndarray] = [next_tokens]
        finished = np.isin(next_tokens, eos_ids)
        if getattr(self.app, "is_fused_spec", False):
            if do_sample:
                logger.warning("fused speculation decodes greedily (draft proposal and "
                               "target verification are argmax); do_sample=True is "
                               "decoded greedily")
            if not finished.all():
                gen = self._fused_spec_decode(next_tokens, lengths, n_new, eos_ids,
                                              pad_token_id, sampling_params, B)
                return self._assemble(input_ids, gen, lengths, pad_token_id)
        if (getattr(self.app, "multistep_supported", False) and not finished.all()
                and not logits_processor and len(eos_ids) <= MULTISTEP_EOS_SLOTS):
            gen = self._multistep_decode_loop(next_tokens, lengths, n_new, eos_ids, pad_token_id,
                                              B, outputs["next_inputs"])
            return self._assemble(input_ids, gen, lengths, pad_token_id)
        if (self.app.async_supported and "next_inputs" in outputs and not finished.all()
                and not logits_processor):
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
                sampling_params=sampling_params, rng=self._rng.next(), **lora_kwargs,
            )
            if logits_processor:
                next_tokens = self._host_select(outputs, running, logits_processor, **select)
                running = np.concatenate([running, next_tokens[:, None]], axis=1)
            else:
                next_tokens = extract_next_tokens(outputs)
            next_tokens = np.where(finished, pad_token_id, next_tokens)
            generated.append(next_tokens)
            finished |= np.isin(next_tokens, eos_ids)
            cur_pos = cur_pos + 1
        return self._assemble(input_ids, np.stack(generated, axis=1), lengths, pad_token_id)

    def _host_select(self, outputs, running, processors, *, do_sample, top_k, top_p,
                     temperature, lengths, prompt_width, pad_token_id) -> np.ndarray:
        """Host logits processors, then the token: argmax, or the same sampler
        the forwards run, with the next key of the schedule. ``running`` is
        the right-padded prompt with the generated tokens appended past
        ``prompt_width``; each row goes to the processors LEFT-padded from its
        true length (HF's layout), so pads are not read as context."""
        with span("token_fetch"):
            scores = outputs["logits"][:, -1, :].float().cpu()
        B, W = running.shape
        ids_np = np.full_like(running, pad_token_id)
        for b in range(B):
            true = np.concatenate([running[b, : lengths[b]], running[b, prompt_width:]])
            ids_np[b, W - true.shape[0]:] = true
        ids = torch.as_tensor(ids_np, dtype=torch.long)
        for proc in processors:
            scores = proc(ids, scores)
        if not do_sample:
            return scores.numpy().argmax(-1).astype(np.int64)
        sp = torch.from_numpy(sampling_ops.prepare_sampling_params(
            B, top_k=[top_k], top_p=[top_p], temperature=[temperature]))
        rng = torch.from_numpy(self._rng.next())
        return sampling_ops.sample(scores.float(), sp, rng=rng, do_sample=True).numpy().astype(
            np.int64)

    def _fused_spec_decode(self, first_tokens, lengths, n_new, eos_ids, pad_token_id,
                           sampling_params, B) -> np.ndarray:
        """Decode window by window (the JAX package's ``_fused_spec_decode``):
        each dispatch retires counts[b] tokens of row b, so positions are
        tracked per row; a token at or past the KV window limit was computed
        against dropped writes and is discarded. Returns (B, T <= n_new),
        the context encoding's token first, padded after each row's EOS."""
        eos_set = set(int(e) for e in eos_ids)
        rows = [[int(first_tokens[b])] for b in range(B)]
        finished = np.array([rows[b][0] in eos_set or n_new <= 1 for b in range(B)])
        cur_tok = np.array(first_tokens, dtype=np.int32)
        cur_pos = lengths.astype(np.int32).copy()  # position of cur_tok
        window_limit = decode_window_limit(self.tpu_config, self.app.models)
        host = _HostTokens()
        while not finished.all():
            outputs = self.app.forward(
                cur_tok[:, None], cur_pos[:, None],
                last_token_index=np.zeros((B,), dtype=np.int32),
                sampling_params=sampling_params)
            # one read of the window: both copies enqueued, then the waits
            handles = [host.push(outputs[k]) for k in ("tokens", "counts")]
            toks, cnts = (host.get(h) for h in handles)
            live = [int(c) for c, f in zip(cnts, finished) if not f]
            self.app.spec_windows += 1
            self.app.spec_accepted_tokens += sum(live)
            for b in range(B):
                if finished[b]:
                    continue
                # token j sits at position cur_pos + 1 + j; a row can still
                # fill to the last slot
                c = min(int(cnts[b]), window_limit - 1 - int(cur_pos[b]))
                if c <= 0:
                    finished[b] = True
                    continue
                for j in range(c):
                    t = int(toks[b, j])
                    rows[b].append(t)
                    if t in eos_set or len(rows[b]) >= n_new:
                        finished[b] = True
                        break
                cur_tok[b] = toks[b, c - 1]
                cur_pos[b] += c
        T = min(n_new, max(len(r) for r in rows))
        gen = np.full((B, T), pad_token_id, dtype=np.int64)
        for b in range(B):
            r = rows[b][:T]
            gen[b, : len(r)] = r
        return gen

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

    def _multistep_decode_loop(self, first_tokens, lengths, n_new, eos_ids, pad_token_id, B,
                               cte_next_inputs) -> np.ndarray:
        """Decode K tokens per dispatch (the ``tkg_multistep`` submodel). Window
        0 chains off the context encoding's ``next_inputs`` on the device;
        window j + 1 is dispatched from window j's before window j's tokens
        are read (lag 1), the rung is the smallest covering what remains,
        and overshoot past EOS or ``n_new`` is trimmed here."""
        w = self.app.models[TAG_TOKEN_GENERATION_MULTISTEP]
        window_limit = decode_window_limit(self.tpu_config, self.app.models)
        remaining = n_new - 1
        token_stream = [first_tokens]
        finished = np.isin(first_tokens, eos_ids)
        if remaining <= 0 or finished.all():
            return np.stack(token_stream, axis=1)
        Bc, dev = w.batch_size, w.device
        eos = np.full((Bc, MULTISTEP_EOS_SLOTS), -1, dtype=np.int32)
        eos[:B, : len(eos_ids)] = eos_ids
        batch = dict(cte_next_inputs)
        batch["eos_token_ids"] = torch.from_numpy(eos).to(dev)
        batch["pad_token_id"] = torch.full((Bc,), pad_token_id, dtype=torch.int32, device=dev)
        host = _HostTokens()
        max_len0 = int(lengths.max())
        pending, produced = [], 0
        while produced < remaining:
            steps = w.select_steps(remaining - produced)
            total_len = min(max_len0 + 1 + produced + steps, window_limit)
            outputs = self.app.token_gen_multistep_device(batch, total_len, steps=steps)
            batch = outputs["next_inputs"]
            pending.append(host.push(outputs["tokens"]))
            produced += steps
            if len(pending) >= 2:  # lag 1: the previous window's tokens
                prev = host.get(pending.pop(0))[:B]
                token_stream.extend(prev.T)
                finished |= np.isin(prev, eos_ids).any(axis=1)
                if finished.all():
                    break
        for handle in pending[-1:]:
            token_stream.extend(host.get(handle)[:B].T)
        gen = np.stack(token_stream, axis=1)[:, :n_new]
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
