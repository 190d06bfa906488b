"""Continuous batching over slot caches: port of
`kivi_tpu/serving/batcher.py` (bucketed and chunked admission; the
prefix paths come with a later slice of the port).

A fixed pool of `num_slots` sequence slots, each with its own cache
position, admitted and retired independently, while one batched decode
step advances every slot together.

  * The slot caches (`modeling.init_slot_caches`) carry one row per slot
    and their counters as (S,) int32 device tensors: the counterpart of
    the JAX batcher's `jax.vmap` over batch-1 caches.  The decode step
    is one `modeling.forward(mode="decode", active=)`: each row flushes
    its own full windows by masked slice writes
    (`kivi_cache.decode_append_masked`, `fp_cache.fp_append_masked`),
    and attention reads each row's counters on the device
    (`fused_decode_attention`, or the fp kernel with per-row lengths).
  * Admission: a request is prefilled alone into a batch-1 host-int
    cache, LEFT-padded to its bucket (one-shot, through flash_attention)
    or to a multiple of `prefill_chunk` (chunked, through the extend
    path), and `kivi_cache.write_slot` copies it into a free slot.
  * Retirement: a slot frees when EOS is sampled or max_new_tokens is
    reached; freed slots keep decoding garbage, but their cache writes
    are masked (frozen counters) and their tokens dropped.
  * The decode step (`_decode_all`) updates every piece of its state in
    place, so that it can be captured: on CUDA one CUDA graph per fill
    bound (`_decode_for`, the JAX batcher's one jit per bound), captured
    on first use and replayed after (utils/graphs.py); on the CPU it
    runs eagerly.  The bound is the fullest active slot's fill after the
    step, from the host's per-slot `fill`, rounded up to 512.

The step reads one thing back to the host, the sampled tokens; the
counters, pads, controls and penalty masks stay on the device.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving import sampling
from kivi_tpu_torch.serving.engine import FILL_BUCKET, phase_period
from kivi_tpu_torch.utils.graphs import StepGraphs

_PREFIX_LATER = ("prefix admission (prefix=, prefix_cache=, "
                 "Request.prefix_tokens) comes with a later slice of the "
                 "port")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    # per-request sampling controls (HF semantics, serving/sampling.py);
    # temperature 0 = greedy.  Applied per slot inside the one batched
    # decode step.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    # streaming: called with each generated token id the step it is
    # harvested (the first at admission, then one per decode step).
    # Exceptions propagate to the step()/run() caller.
    on_token: Optional[Callable[[int], None]] = None
    # per-request prefix through a PrefixCache: a later slice of the port
    prefix_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    # buckets always end at max_seq_len (see __init__), so a request that
    # passed the admission length check always finds a bucket
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class ContinuousBatcher:
    """Synchronous continuous-batching loop on one device.  Runs on CUDA
    (the kernels) unless built with device="cpu" (the plain versions).

    params: the port's parameter dict, already on `device`.  Sampled
    tokens are drawn from a torch.Generator seeded with 0 (the JAX
    batcher's PRNGKey(0))."""

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, params,
                 num_slots: int, max_seq_len: int, device=None,
                 prompt_buckets=(128, 256, 512, 1024, 2048, 4096),
                 prefill_chunk: int = 0, prefix=None, prefix_cache=None,
                 cache_dtype=torch.bfloat16):
        if prefix is not None or prefix_cache is not None:
            raise NotImplementedError(_PREFIX_LATER)
        self.cfg, self.qcfg, self.params = cfg, qcfg, params
        self.S, self.T = num_slots, max_seq_len
        self.device = modeling.resolve_device(device)
        # the bucket list always tops out at max_seq_len: any prompt that
        # fits the cache finds a bucket
        buckets = tuple(b for b in prompt_buckets if b < max_seq_len)
        self.prompt_buckets = buckets + (max_seq_len,)
        # prefill_chunk > 0: admission prefills in fixed chunks through
        # the extend path instead of one-shot per bucket; over a KIVI
        # cache the chunk rounds up to the phase period, so every
        # interior chunk sits on one quantization phase
        if prefill_chunk and qcfg.quantize_kv:
            L = phase_period(qcfg)
            if prefill_chunk % L:
                prefill_chunk += L - prefill_chunk % L
        self.prefill_chunk = prefill_chunk

        dev = self.device
        self.caches = modeling.init_slot_caches(cfg, qcfg, num_slots,
                                                max_seq_len, cache_dtype, dev)
        # the admission prefill's batch-1 cache, reused (zeroed) per
        # request and copied into the slot
        self._one = modeling.init_caches(cfg, qcfg, 1, max_seq_len,
                                         cache_dtype, dev)

        # host-side slot table
        self.active = np.zeros(num_slots, bool)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_out: List[List[int]] = [[] for _ in range(num_slots)]
        self.queue: deque[Request] = deque()
        self.results: Dict[int, Result] = {}

        # device-side per-slot state (pos = TRUE rope position, i.e. the
        # slot's cache position minus its left pad)
        def z(dt, fill=0):
            return torch.full((num_slots,), fill, dtype=dt, device=dev)

        self.cur_tok = z(torch.int64)[:, None]
        self.pos = z(torch.int64)[:, None]
        self.pad_dev = z(torch.int64)
        self.act_dev = z(torch.bool)
        self.temp_dev = z(torch.float32)
        self.topk_dev = z(torch.int64)
        self.topp_dev = z(torch.float32, 1.0)
        self.pen_dev = z(torch.float32, 1.0)
        # per-slot token-id mask of the sequence so far (prompt +
        # generated), for the repetition penalty (HF penalizes over the
        # full input_ids)
        self.seen_dev = torch.zeros((num_slots, cfg.vocab_size),
                                    dtype=torch.bool, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)
        # the step's outputs, written in place: raw logits (S, V) of the
        # last decode step, before the penalty, and its sampled tokens
        self.last_logits = torch.zeros((num_slots, cfg.vocab_size),
                                       dtype=torch.float32, device=dev)
        self.nxt = z(torch.int32)
        # per-slot cache tokens (pads included) on the host: the decode
        # step's fill bound comes from them, with no device read
        self.fill = np.zeros(num_slots, np.int64)
        self.graphs = StepGraphs(dev) if dev.type == "cuda" else None

    # -- device work ----------------------------------------------------------

    def _first_token(self, logits, seen, req: Request) -> torch.Tensor:
        """Sample an admitted request's first token from its prefill
        logits (1, V) under its own controls."""
        def c(x, dt):
            return torch.tensor([x], dtype=dt, device=self.device)

        lg = sampling.apply_repetition_penalty_per_row(
            logits, seen, c(req.repetition_penalty, torch.float32))
        return sampling.sample_step_per_row(
            lg, self.gen, c(req.temperature, torch.float32),
            c(req.top_k, torch.int64), c(req.top_p, torch.float32))

    def _prefill_one(self, prompt: List[int], bucket: int):
        """Prefill one prompt, LEFT-padded to `bucket`, into the reused
        batch-1 cache.  Returns (last-token logits (1, V), pad)."""
        pad = bucket - len(prompt)
        toks = torch.tensor([[0] * pad + prompt], dtype=torch.int64,
                            device=self.device)
        padv = torch.tensor([pad], dtype=torch.int64, device=self.device)
        for c in self._one:
            KC.clear(c)
        C = self.prefill_chunk or bucket
        mode = "extend" if self.prefill_chunk else "prefill"
        logits = None
        for t0 in range(0, bucket, C):
            positions = torch.clamp(
                t0 + torch.arange(C, device=self.device)[None, :] - pad,
                min=0)
            logits, _ = modeling.forward(
                self.params, toks[:, t0:t0 + C], self._one, self.cfg,
                self.qcfg, positions, mode=mode, last_only=True,
                pad_len=padv, prev_len=t0)
        return logits[:, -1], pad

    def _decode_all(self, fill_bound: Optional[int] = None
                    ) -> torch.Tensor:
        """One decode step for all slots: one batched forward over the
        slot caches (inactive slots frozen), then per-row penalty and
        sampling; the sampled token becomes each slot's next input and
        the active slots' positions advance.  fill_bound: a static bound
        on every ACTIVE slot's fill after the step.  Every write is in
        place (the body a CUDA graph captures).  Returns the sampled
        tokens, self.nxt (S,) int32 on the device."""
        logits, _ = modeling.forward(
            self.params, self.cur_tok, self.caches, self.cfg, self.qcfg,
            self.pos, mode="decode", pad_len=self.pad_dev,
            active=self.act_dev, fill_bound=fill_bound)
        self.last_logits.copy_(logits[:, -1])
        # the consumed token joins the sequence before the penalty
        # (engine/HF ordering)
        self.seen_dev.scatter_(1, self.cur_tok, True)
        lg = sampling.apply_repetition_penalty_per_row(
            self.last_logits, self.seen_dev, self.pen_dev)
        self.nxt.copy_(sampling.sample_step_per_row(
            lg, self.gen, self.temp_dev, self.topk_dev, self.topp_dev))
        self.cur_tok.copy_(self.nxt[:, None])
        self.pos += self.act_dev.to(torch.int64)[:, None]
        return self.nxt

    def _decode_for(self, fb: int) -> Callable[[], torch.Tensor]:
        """The decode step under fill bound fb: on CUDA a replay of the
        CUDA graph captured for fb (captured on first use: at most
        T / 512 graphs, the bound growing with the fullest slot), on the
        CPU the body itself."""
        body = functools.partial(self._decode_all, fb)
        if self.graphs is None:
            return body

        def replay():
            self.graphs.run(fb, body, (self.gen,))
            return self.nxt

        return replay

    # -- host-side loop -------------------------------------------------------

    def submit(self, req: Request):
        if req.prefix_tokens:
            raise NotImplementedError(_PREFIX_LATER)
        self.queue.append(req)

    def cancel(self, uid: int) -> bool:
        """Stop a request: drop it from the queue, or free its slot if it
        is mid-decode.  Records an empty/partial Result so run() still
        terminates.  Returns True if the uid was found live."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                self.results[uid] = Result(uid, [])
                return True
        for s in range(self.S):
            req = self.slot_req[s]
            if req is not None and req.uid == uid:
                self.results[uid] = Result(uid, self.slot_out[s])
                self._free(s)
                return True
        return False

    def _free(self, s: int):
        self.active[s] = False
        self.act_dev[s] = False
        self.slot_req[s] = None
        self.slot_out[s] = []

    def _bucket_for(self, n: int) -> Optional[int]:
        """Padded prompt length for an n-token prompt: the next multiple
        of prefill_chunk in chunked mode, else the configured bucket;
        None if it cannot fit the cache."""
        if n > self.T:
            return None
        if self.prefill_chunk:
            C = self.prefill_chunk
            b = ((n + C - 1) // C) * C
            return b if b <= self.T else None
        return _bucket(n, self.prompt_buckets)

    def _host_seen(self, token_lists) -> torch.Tensor:
        """(1, V) bool repetition-penalty mask over raw token lists."""
        seen = np.zeros((1, self.cfg.vocab_size), bool)
        for toks in token_lists:
            seen[0, np.asarray(toks, np.int64)] = True
        return torch.from_numpy(seen).to(self.device)

    def _admit(self):
        while self.queue and not self.active.all():
            req = self.queue[0]
            # cache usage is bucket + max_new (pad slots occupy cache
            # positions), so admission checks the BUCKETED length; an
            # empty prompt has no logits to sample a first token from
            bucket = self._bucket_for(len(req.prompt))
            if (not req.prompt or bucket is None
                    or bucket + req.max_new_tokens > self.T):
                self.queue.popleft()
                self.results[req.uid] = Result(req.uid, [])  # rejected
                continue
            slot = int(np.argmin(self.active))
            req = self.queue.popleft()
            prompt = [int(t) for t in req.prompt]
            logits, pad = self._prefill_one(prompt, bucket)
            seen0 = self._host_seen([prompt])
            nxt = self._first_token(logits, seen0, req)
            # write slot state
            for big, one in zip(self.caches, self._one):
                KC.write_slot(big, slot, one)
            self.cur_tok[slot, 0] = nxt[0]
            # rope position of the first generated token = true length
            self.pos[slot, 0] = len(prompt)
            self.pad_dev[slot] = pad
            self.act_dev[slot] = True
            self.temp_dev[slot] = req.temperature
            self.topk_dev[slot] = req.top_k
            self.topp_dev[slot] = req.top_p
            self.pen_dev[slot] = req.repetition_penalty
            self.seen_dev[slot] = seen0[0]
            self.active[slot] = True
            self.slot_req[slot] = req
            self.slot_out[slot] = [int(nxt[0])]
            self.fill[slot] = bucket   # cache tokens, pads included
            if req.on_token is not None:
                req.on_token(self.slot_out[slot][0])

    def _retire(self):
        for s in range(self.S):
            req = self.slot_req[s]
            if req is None:
                continue
            out = self.slot_out[s]
            done = len(out) >= req.max_new_tokens or (
                req.eos_token_id is not None and out
                and out[-1] == req.eos_token_id)
            if done:
                self.results[req.uid] = Result(req.uid, out)
                self._free(s)

    def step(self):
        """Admit pending requests, run one decode step, harvest tokens."""
        self._retire()
        self._admit()
        if not self.active.any():
            return
        # the live-fill bound: this step appends one token per active
        # slot.  INVARIANT (kivi_tpu/serving/batcher.py:524-528): fb
        # covers the ACTIVE slots only.  A retired slot's counters may
        # pass it, so its attention is truncated; that is safe only
        # because an inactive slot's sampled token is dropped and its
        # cache writes are masked.  Never read an inactive slot's output.
        fb = int(min(-(-(int(self.fill[self.active].max()) + 1)
                       // FILL_BUCKET) * FILL_BUCKET, self.T))
        nxt = self._decode_for(fb)()
        nxt_host = nxt.cpu().numpy()          # the step's one host read
        self.fill[self.active] += 1
        for s in range(self.S):
            if self.active[s] and self.slot_req[s] is not None:
                tok = int(nxt_host[s])
                self.slot_out[s].append(tok)
                req = self.slot_req[s]
                if req.on_token is not None:
                    req.on_token(tok)

    def run(self, requests: List[Request]) -> Dict[int, Result]:
        """Drive until every submitted request completes."""
        for r in requests:
            self.submit(r)
        while self.queue or self.active.any():
            self.step()
        self._retire()
        return self.results
