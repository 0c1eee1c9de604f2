"""Continuous-batching decode engine: fixed slots serving mixed
prefill+decode batches, with a chunked-prefill fast path — the port of
``dear_pytorch_tpu/serving/engine.py``.

Two step shapes drive the model (`models.gpt.GptLmHeadModel` or
`models.bert.BertForPreTraining` in decode mode, over the ring KV cache of
`serving.kvcache`):

  - the **decode tick** ``[slots, 1]``: every active slot advances one
    token — a prompt token while it prefills, its own last sample while it
    decodes — at that slot's own position. A new request enters the batch
    the moment a slot frees;
  - the **prefill tick** ``[slots, C]`` (``prefill_chunk=C > 1``): every
    PREFILLING slot consumes up to C prompt tokens in one step; decoding
    slots ride along frozen (zero valid tokens).

Slot reuse is free: the ring cache derives validity from the position
alone, so assigning a request resets the slot's position to 0 and every
stale entry is invalid by construction. Chunk logits equal the
token-at-a-time logits, so chunking changes latency, never tokens.

**Interleave policy**: a prefill tick is taken only when some slot has at
least 2 prompt tokens left, and at most ``prefill_burst`` prefill ticks
run in a row while any slot is decoding. ``prefill_chunk=1`` makes every
tick a mixed decode tick.

Sampling is greedy (argmax over the un-padded vocab, first maximal index
on ties, as in the JAX engine), so a re-dispatched request reproduces the
same tokens; the constructor enforces ``sampler="greedy"``.

Per-phase tick latencies (host clock around a step that ends in a
device-to-host copy of the sampled tokens) feed `phase_gauges`; each
phase's first tick is excluded (the first launch of a step builds and
loads kernels and handles). ``decode_steps`` / ``prefill_steps`` count
ticks by kind. Not in this slice: the ``serve.*`` telemetry export and
trace spans (the observability slice) and ring
tensor-parallel decode (the tensor-parallel slice).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from dear_pytorch_tpu_torch._device import check_model_device

__all__ = ["DecodeEngine", "FinishedRequest", "sorted_quantile"]

_PHASE_WINDOW = 256  # recent ticks per phase behind the latency gauges


def sorted_quantile(sorted_vals, p: float):
    """Nearest-rank quantile of an ASCENDING-sorted sequence (the JAX
    package's ``observability/export.py`` convention). None when empty."""
    if not sorted_vals:
        return None
    n = len(sorted_vals)
    return sorted_vals[min(int(p * (n - 1)), n - 1)]


@dataclasses.dataclass
class FinishedRequest:
    """One completed generation: the request id handed to `submit`, the
    prompt, the generated continuation, and per-phase accounting."""

    request_id: Any
    prompt: List[int]
    tokens: List[int]          # generated continuation only
    steps: int                 # engine ticks this request was live for
    prefill_s: float = 0.0     # wall seconds attributed to prefill ticks
    decode_s: float = 0.0      # wall seconds attributed to decode ticks
    trace: Optional[dict] = None  # propagated trace context, verbatim


class _Slot:
    __slots__ = ("req_id", "prompt", "max_new", "eos_id", "fed",
                 "generated", "ticks", "prefill_s", "decode_s", "trace")

    def __init__(self, req_id, prompt, max_new, eos_id, trace=None):
        self.req_id = req_id
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.fed = 0               # tokens fed so far == next position
        self.generated: List[int] = []
        self.ticks = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.trace = trace

    def next_token(self) -> int:
        if self.fed < len(self.prompt):
            return self.prompt[self.fed]
        return self.generated[self.fed - len(self.prompt)]

    @property
    def prompt_remaining(self) -> int:
        return max(len(self.prompt) - self.fed, 0)


class DecodeEngine:
    """Fixed-slot continuous-batching decoder over a causal LM.

    ``model`` has the decode contract of `models.gpt.GptLmHeadModel` and
    `models.bert.BertForPreTraining`: ``model.init_cache(slots)`` and
    ``model(tokens [B, S], position_offset=[B], cache=,
    prefill_lengths=[B] or None)`` returning next-token logits, or a tuple
    whose first element is the logits (BERT's ``(prediction_logits,
    nsp_logits)``). The engine owns the ring caches and the per-slot
    positions.
    `submit` assigns a request to a free slot, `tick` advances the batch
    one step. Runs on the card unless ``device`` (which must be the
    model's) says otherwise.
    """

    def __init__(self, model, *, slots: int = 4,
                 eos_id: Optional[int] = None, prefill_chunk: int = 1,
                 prefill_burst: int = 2, sampler: str = "greedy",
                 tp_mesh=None, device=None):
        if sampler != "greedy":
            raise ValueError(
                f"DecodeEngine supports only sampler='greedy', got "
                f"{sampler!r}: generation must be deterministic so the "
                "router can re-dispatch a dead replica's in-flight "
                "requests and get byte-identical responses "
                "(docs/SERVING.md zero-drop contract). A stochastic "
                "sampler needs a generation-state handoff protocol first."
            )
        if tp_mesh is not None:
            raise NotImplementedError(
                "ring tensor-parallel decode (tp_mesh) is the "
                "tensor-parallel slice's work")
        self.device = check_model_device(model.device, device)
        self.model = model
        self.slots = int(slots)
        self.eos_id = eos_id
        cfg = model.config
        self.vocab_size = int(cfg.vocab_size)
        self.max_positions = int(cfg.max_position_embeddings)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if self.prefill_chunk > cfg.cache_len:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) exceeds the KV "
                f"ring length ({cfg.cache_len}); a chunk must not "
                "overwrite its own attention window")
        self.prefill_burst = max(int(prefill_burst), 1)
        self._cache = model.init_cache(self.slots)
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._prefill_streak = 0
        self._prefill_tick_s: deque = deque(maxlen=_PHASE_WINDOW)
        self._decode_tick_s: deque = deque(maxlen=_PHASE_WINDOW)
        self._decode_warm = False
        self._prefill_warm = False
        #: ticks run so far, by kind (the JAX engine's serve.decode_steps /
        #: serve.prefill_steps counters)
        self.decode_steps = 0
        self.prefill_steps = 0

    # -- slot management -----------------------------------------------------

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def free(self) -> int:
        return self.slots - self.active

    def submit(self, prompt, max_new_tokens: int,
               request_id=None, trace=None) -> Optional[int]:
        """Assign a request to a free slot (None when the batch is full).
        ``trace`` rides to the `FinishedRequest` untouched. Returns the
        slot index."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_positions:
            raise ValueError(
                f"prompt + new tokens ({total}) exceeds the position "
                f"budget ({self.max_positions})"
            )
        for b, s in enumerate(self._slots):
            if s is None:
                # position restarts at 0: the ring cache derives validity
                # from the position, so the previous occupant's entries
                # are invalid without any reset pass
                self._slots[b] = _Slot(request_id, prompt, max_new_tokens,
                                       self.eos_id, trace=trace)
                return b
        return None

    # -- per-phase latency export --------------------------------------------

    def phase_gauges(self) -> dict:
        """Quantile gauges (ms) over the recent per-phase tick latencies."""
        out = {}
        for name, ring in (("serve.prefill_ms", self._prefill_tick_s),
                           ("serve.decode_tick_ms", self._decode_tick_s)):
            if not ring:
                continue
            lats = sorted(ring)
            out[f"{name}_p50"] = round(sorted_quantile(lats, 0.50) * 1e3, 3)
            out[f"{name}_p99"] = round(sorted_quantile(lats, 0.99) * 1e3, 3)
        return out

    # -- the tick ------------------------------------------------------------

    def _want_prefill_tick(self) -> bool:
        """The interleave policy: chunk when it helps, never more than
        ``prefill_burst`` in a row while decodes wait."""
        if self.prefill_chunk <= 1:
            return False
        chunkable = any(s is not None and s.prompt_remaining >= 2
                        for s in self._slots)
        if not chunkable:
            return False
        decoding = any(s is not None and s.prompt_remaining == 0
                       for s in self._slots)
        return not (decoding and self._prefill_streak >= self.prefill_burst)

    def tick(self) -> List[FinishedRequest]:
        """Advance the batch one step — a chunked prefill tick or a mixed
        decode tick per the interleave policy; returns the requests that
        finished this tick."""
        if self.active == 0:
            return []
        if self._want_prefill_tick():
            self._prefill_streak += 1
            return self._prefill_tick()
        self._prefill_streak = 0
        return self._decode_tick()

    def _run(self, toks: np.ndarray, pos: np.ndarray,
             nvalid: Optional[np.ndarray]) -> np.ndarray:
        """One model step; the greedy token at each row's last valid
        position, copied to the host (the tick's one device sync)."""
        dev = self.device
        with torch.no_grad():
            logits = self.model(
                torch.from_numpy(toks).to(dev),
                position_offset=torch.from_numpy(pos).to(dev),
                cache=self._cache,
                prefill_lengths=(None if nvalid is None
                                 else torch.from_numpy(nvalid).to(dev)))
            if isinstance(logits, tuple):      # BERT: (mlm, nsp)
                logits = logits[0]
            nxt = logits[..., :self.vocab_size].argmax(dim=-1)   # [B, S]
            if nvalid is None:
                sampled = nxt[:, 0]
            else:
                last = np.clip(nvalid - 1, 0, toks.shape[1] - 1)
                sampled = nxt[torch.arange(len(last), device=dev),
                              torch.from_numpy(last).to(dev)]
            return sampled.cpu().numpy()

    def _prefill_tick(self) -> List[FinishedRequest]:
        B, C = self.slots, self.prefill_chunk
        toks = np.zeros((B, C), np.int64)
        pos = np.zeros((B,), np.int64)
        nvalid = np.zeros((B,), np.int64)
        for b, s in enumerate(self._slots):
            if s is None or s.prompt_remaining == 0:
                continue  # decoding/idle rows ride along frozen
            n = min(C, s.prompt_remaining)
            toks[b, :n] = s.prompt[s.fed:s.fed + n]
            pos[b] = s.fed
            nvalid[b] = n
        t0 = time.monotonic()
        sampled = self._run(toks, pos, nvalid)
        dt = time.monotonic() - t0
        self.prefill_steps += 1
        if not self._prefill_warm:             # the first, cold tick
            self._prefill_warm = True
            dt = 0.0
        else:
            self._prefill_tick_s.append(dt)
        finished: List[FinishedRequest] = []
        for b, s in enumerate(self._slots):
            if s is None:
                continue
            n = int(nvalid[b])
            if n == 0:
                continue                       # frozen this tick
            s.fed += n
            s.ticks += 1
            s.prefill_s += dt
            if s.fed >= len(s.prompt):         # prompt consumed: this
                nxt = int(sampled[b])          # tick's logits sample
                s.generated.append(nxt)
                done = (len(s.generated) >= s.max_new
                        or (s.eos_id is not None and nxt == s.eos_id))
                if done:
                    finished.append(self._finish(b, s))
        return finished

    def _decode_tick(self) -> List[FinishedRequest]:
        B = self.slots
        toks = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int64)
        prefilling = [False] * B
        for b, s in enumerate(self._slots):
            if s is None:
                continue  # idle rows feed token 0 at position 0
            toks[b, 0] = s.next_token()
            pos[b] = s.fed
            prefilling[b] = s.prompt_remaining > 0
        t0 = time.monotonic()
        sampled = self._run(toks, pos, None)
        dt = time.monotonic() - t0
        self.decode_steps += 1
        if not self._decode_warm:              # the first, cold tick
            self._decode_warm = True
            dt = 0.0
        else:
            self._decode_tick_s.append(dt)
        finished: List[FinishedRequest] = []
        for b, s in enumerate(self._slots):
            if s is None:
                continue
            s.fed += 1
            s.ticks += 1
            # a mixed tick is attributed per slot by the phase it was in
            if prefilling[b]:
                s.prefill_s += dt
            else:
                s.decode_s += dt
            if s.fed >= len(s.prompt):       # the prompt is consumed:
                nxt = int(sampled[b])        # this tick's logits sample
                s.generated.append(nxt)
                done = (len(s.generated) >= s.max_new
                        or (s.eos_id is not None and nxt == s.eos_id))
                if done:
                    finished.append(self._finish(b, s))
        return finished

    def _finish(self, b: int, s: _Slot) -> FinishedRequest:
        self._slots[b] = None
        return FinishedRequest(s.req_id, s.prompt, s.generated, s.ticks,
                               prefill_s=round(s.prefill_s, 6),
                               decode_s=round(s.decode_s, 6),
                               trace=s.trace)
