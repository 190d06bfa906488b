"""Continuous batching over slot caches: port of
`kivi_tpu/serving/batcher.py`.

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
  * Prefix admission (a batcher-wide `prefix` snapshot, or
    `Request.prefix_tokens` through a `PrefixCache`): the snapshot is
    copied into the batch-1 cache and only the request's own tokens are
    ingested, unpadded: whole `prefill_chunk` chunks through the extend
    path, then the ragged tail teacher-forced through decode steps, one
    a token (`_tail_step`, over the batch-1 cache's counters moved to
    the device; on CUDA one graph per fill bound).
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

With the tracer on (utils/profiling.py), a step is a `batcher.step` span
(`active` slots decoded, `admitted`, `fb`) holding `batcher.retire`, one
`batcher.admit` per admission (`uid`, `prompt` tokens, `bucket` tokens
prefilled, pads included, `prefix`; its parts `.prefill`, `.sample`,
`.write_slot` and `.read`, the host's one read of the first token),
`batcher.decode` (`fb`), `batcher.read` and `batcher.emit`; a
`batcher.queue` span runs from a request's `submit()` to its
`batcher.admit`.

`ContinuousBatcher(mesh=)` splits the model over the mesh's "model"
axis as `Engine(mesh=)` does (this rank's slice of the params, the
local head counts, the model group's collectives in every forward;
kivi_tpu/parallel/elastic.py:273-292 builds the JAX batcher over
sharded params).  The slots are not split over "data": each data rank
serves the same slots, as the JAX batcher's unsharded slot caches are
replicated.  Every rank of a model group samples from a generator with
the same seed, over the same gathered logits, so all pick the same
tokens.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.parallel import mesh as M
from kivi_tpu_torch.serving import sampling
from kivi_tpu_torch.serving.engine import FILL_BUCKET, phase_period
from kivi_tpu_torch.utils.graphs import StepGraphs
from kivi_tpu_torch.utils.guards import checked_call
from kivi_tpu_torch.utils.profiling import TRACER, record, span


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
    # per-request prefix: token ids resolved through the batcher's
    # PrefixCache at admission (exact hit, extend of the longest stored
    # prefix, or a fresh prefill); overrides the batcher-wide `prefix`
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
    batcher's PRNGKey(0)).

    prefix: an `Engine.prefill_prefix` snapshot shared by every request
    (system-prompt serving); prefix_cache: a `PrefixCache` serving
    `Request.prefix_tokens`.  Both must come from an Engine of this
    batcher's config, cache length and cache dtype.  debug=True: the
    same program run eagerly, every admission forward, tail step and
    decode step a checked call (utils/guards.py, as Engine(debug=True)).

    mesh: a (data, model) DeviceMesh; params are then this rank's slice
    (`parallel.mesh.shard_params`) and `self.cfg` the local config
    (module docstring).
    """

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, params,
                 num_slots: int, max_seq_len: int, device=None,
                 prompt_buckets=(128, 256, 512, 1024, 2048, 4096),
                 prefill_chunk: int = 0, prefix=None, prefix_cache=None,
                 cache_dtype=torch.bfloat16, debug: bool = False,
                 mesh=None):
        modeling.reject_rings(cfg, f"{type(self).__name__}")
        cfg = M.local_config(cfg, M.mesh_coords(mesh)[2])
        M.check_local_params(params, cfg)
        self.cfg, self.qcfg, self.params = cfg, qcfg, params
        self.prefix, self.prefix_cache = prefix, prefix_cache
        self.debug = debug
        # the model, with this rank's tensor-parallel group
        self._model = functools.partial(modeling.forward,
                                        tp=M.group_of(mesh, M.MODEL_AXIS))
        self._forward = (checked_call(self._model) if debug
                         else self._model)
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
        # uid -> time.perf_counter_ns() at submit(), while tracing
        self._submitted: Dict[int, int] = {}

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
        self.graphs = (StepGraphs(dev) if dev.type == "cuda" and not debug
                       else None)
        # the prefix admission's tail step state, at fixed addresses: the
        # token fed and its position (1, 1), the step's logits (1, V), and
        # the batch-1 cache's device counters
        self._tail_tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        self._tail_pos = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        self._tail_logits = torch.zeros((1, cfg.vocab_size),
                                        dtype=torch.float32, device=dev)
        self._one_ctr: Optional[torch.Tensor] = None

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
            logits, _ = self._forward(
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
        logits, _ = self._model(
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
        if self.debug:
            return checked_call(body)
        if self.graphs is None:
            return body

        def replay():
            self.graphs.run(fb, body, (self.gen,))
            return self.nxt

        return replay

    def _tail_step(self, fill_bound: int) -> None:
        """One step of the prefix admission's tail
        (kivi_tpu/serving/batcher.py:243-273): the tail token in
        _tail_tok through a decode step of the batch-1 cache (its
        counters on the device, each window flushed as it fills), its
        logits kept.  Every write is in place (the body a CUDA graph
        captures); fill_bound: a static bound on the cache's fill."""
        logits, _ = self._model(
            self.params, self._tail_tok, self._one, self.cfg, self.qcfg,
            self._tail_pos, mode="decode", fill_bound=fill_bound)
        self._tail_logits.copy_(logits[:, -1])
        self._tail_pos += 1

    def _ingest_prefixed(self, prefix, prompt: List[int]) -> torch.Tensor:
        """Admission behind a prefix snapshot: the snapshot copied into
        the batch-1 cache, then only the prompt's own tokens, unpadded:
        whole prefill_chunk chunks through the extend path at prev_len =
        P + i, then the ragged tail one decode step a token (the cache's
        counters on the device meanwhile; the JAX batcher runs blocks of
        TAIL masked steps, one compiled scan for every length).  The
        snapshot is read, never written.  Returns the last prompt token's
        logits (1, V)."""
        P, dev = prefix.length, self.device
        for c, s in zip(self._one, prefix.caches):
            KC.broadcast_rows_into(c, s)
        toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
        C, i, logits = self.prefill_chunk, 0, None
        while C and len(prompt) - i >= C:
            positions = (P + i + torch.arange(C, device=dev))[None]
            logits, _ = self._forward(
                self.params, toks[:, i:i + C], self._one, self.cfg,
                self.qcfg, positions, mode="extend", last_only=True,
                prev_len=P + i)
            logits = logits[:, -1]
            i += C
        if i == len(prompt):
            return logits
        cm = KC if self.qcfg.quantize_kv else FC
        self._one_ctr = cm.counters_to_device(self._one, self._one_ctr)
        fb = min(-(-(P + len(prompt)) // FILL_BUCKET) * FILL_BUCKET, self.T)
        step = functools.partial(self._tail_step, fb)
        if self.debug:
            step = checked_call(step)
        self._tail_pos.fill_(P + i)
        for i in range(i, len(prompt)):
            self._tail_tok.copy_(toks[:, i:i + 1])
            if self.graphs is not None:
                self.graphs.run(("tail", fb), step)
            else:
                step()
        cm.counters_to_host(self._one, self._one_ctr)
        return self._tail_logits

    # -- host-side loop -------------------------------------------------------

    def submit(self, req: Request):
        if req.prefix_tokens is not None and not req.prefix_tokens:
            req = dataclasses.replace(req, prefix_tokens=None)
        if req.prefix_tokens is not None and self.prefix_cache is None:
            raise ValueError(
                "Request.prefix_tokens needs ContinuousBatcher("
                "prefix_cache=PrefixCache(...))")
        if TRACER.on:
            self._submitted[req.uid] = time.perf_counter_ns()
        self.queue.append(req)

    def cancel(self, uid: int) -> bool:
        """Stop a request: drop it from the queue, or free its slot if it
        is mid-decode.  Records an empty/partial Result so run() still
        terminates.  Returns True if the uid was found live."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                self._submitted.pop(uid, None)
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

    def _admit(self) -> int:
        """Admit queued requests while a slot is free; returns how many
        were admitted."""
        admitted = 0
        while self.queue and not self.active.all():
            req = self.queue[0]
            # the capacity check comes before any prefix work: the
            # prefix's length is its token count, so an oversized request
            # is refused without paying its prefix prefill
            has_prefix = (req.prefix_tokens is not None
                          or self.prefix is not None)
            P = (len(req.prefix_tokens) if req.prefix_tokens is not None
                 else self.prefix.length if self.prefix is not None else 0)
            # cache usage is P + bucket + max_new (pad slots occupy cache
            # positions), so admission checks the BUCKETED length; a
            # prefix admission is unpadded.  An empty prompt has no
            # logits to sample a first token from
            bucket = ((len(req.prompt) or None) if has_prefix
                      else self._bucket_for(len(req.prompt)))
            submitted = self._submitted.pop(req.uid, None)
            if (not req.prompt or bucket is None
                    or P + bucket + req.max_new_tokens > self.T):
                self.queue.popleft()
                self.results[req.uid] = Result(req.uid, [])  # rejected
                continue
            if submitted is not None:
                record("batcher.queue", submitted, time.perf_counter_ns(),
                       uid=req.uid)
            with span("batcher.admit", uid=req.uid, prompt=len(req.prompt),
                      bucket=bucket, prefix=has_prefix):
                self._admit_one(P, bucket)
            admitted += 1
        return admitted

    def _admit_one(self, P: int, bucket: int) -> None:
        """The queue's head into the first free slot: prefilled (P prefix
        tokens before it, `bucket` tokens prefilled), its first token
        sampled and read, the slot's state written."""
        with span("batcher.admit.prefill"):
            req = self.queue[0]
            # a per-request prefix (through the prefix cache) overrides
            # the batcher-wide one
            prefix = (self.prefix_cache.get(req.prefix_tokens)
                      if req.prefix_tokens is not None else self.prefix)
            slot = int(np.argmin(self.active))
            req = self.queue.popleft()
            prompt = [int(t) for t in req.prompt]
            if prefix is None:
                logits, pad = self._prefill_one(prompt, bucket)
            else:
                logits, pad = self._ingest_prefixed(prefix, prompt), 0
        with span("batcher.admit.sample"):
            seen0 = self._host_seen(
                [prompt] if prefix is None
                else [prefix.tokens[0].cpu().numpy(), prompt])
            nxt = self._first_token(logits, seen0, req)
        with span("batcher.admit.write_slot"):
            for big, one in zip(self.caches, self._one):
                KC.write_slot(big, slot, one)
            self.cur_tok[slot, 0] = nxt[0]
            # rope position of the first generated token = true length
            self.pos[slot, 0] = P + len(prompt)
            self.pad_dev[slot] = pad
            self.act_dev[slot] = True
            self.temp_dev[slot] = req.temperature
            self.topk_dev[slot] = req.top_k
            self.topp_dev[slot] = req.top_p
            self.pen_dev[slot] = req.repetition_penalty
            self.seen_dev[slot] = seen0[0]
            self.active[slot] = True
            self.slot_req[slot] = req
            # cache tokens, pads included: a prefix admission holds
            # P + prompt unpadded, a bucketed one the whole bucket
            self.fill[slot] = P + len(prompt) if prefix is not None \
                else bucket
        with span("batcher.admit.read"):
            first = int(nxt[0])
        self.slot_out[slot] = [first]
        if req.on_token is not None:
            req.on_token(first)

    def _retire(self):
        with span("batcher.retire") as sp:
            retired = 0
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
                    retired += 1
            sp.attrs["retired"] = retired

    def step(self):
        """Admit pending requests, run one decode step, harvest tokens."""
        with span("batcher.step") as sp:
            self._retire()
            sp.attrs["admitted"] = self._admit()
            if not self.active.any():
                sp.attrs["active"] = 0
                return
            sp.attrs["active"] = int(np.count_nonzero(self.active))
            # the live-fill bound: this step appends one token per active
            # slot.  INVARIANT (kivi_tpu/serving/batcher.py:524-528): fb
            # covers the ACTIVE slots only.  A retired slot's counters may
            # pass it, so its attention is truncated; that is safe only
            # because an inactive slot's sampled token is dropped and its
            # cache writes are masked.  Never read an inactive slot's
            # output.
            fb = int(min(-(-(int(self.fill[self.active].max()) + 1)
                           // FILL_BUCKET) * FILL_BUCKET, self.T))
            sp.attrs["fb"] = fb
            with span("batcher.decode", fb=fb):
                nxt = self._decode_for(fb)()
            with span("batcher.read"):
                nxt_host = nxt.cpu().numpy()      # the step's one host read
            self.fill[self.active] += 1
            with span("batcher.emit"):
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
