"""Generation engine over the KIVI cache or the fp16 cache (the
baseline): port of the main-path subset of `kivi_tpu/serving/engine.py`
— one-shot prefill (`prefill`) or chunked prefill through the extend
path (`prefill_chunked`), then decode.

Decode is the port of the JAX engine's compiled `_decode_scan_fn`
(kivi_tpu/serving/engine.py:312-398).  As there, a KIVI cache's window
flushes run unconditionally at the steps the flush schedule fixes for
the known prompt length, between plain steps that do no flush checks;
the fp cache has no flushes.  A plain step (forward, repetition
penalty, sampling, and the in-place update of the token, the position
and the penalty mask) runs over the caches' counters moved to the
device, (B,) int32 per counter (`counters_to_device`; the JAX scan's
traced counters), with the decode kernels' grids cut at a static fill
bound, prompt_len + steps rounded up to 512 (`_decode_scan`, :195-220).
On CUDA the step is captured once as a CUDA graph per static key
(utils/graphs.py: batch, fill bound, sampling controls) and replayed
`steps` times; the flushes run eagerly between replays (the masked
flushes with no predicate: every row's window is full at a scheduled
step).  On the CPU the same step runs eagerly.  The tokens land in a
preallocated device buffer, and the counters return to host ints with
one read at the end.

`Engine(debug=True)` is the port of the JAX engine's checked_jit mode
(utils/guards.py): it runs the same program, with nothing captured.
Every prefill forward, every scheduled flush and every decode step
(the same body over the same device counters and fill bound) is a
checked call, run eagerly, that raises on the first non-finite logit or
appended K/V value, on a violated fill bound, or on a flush schedule
that does not match the caches.  The split decode route (rows 7-8 of
the kernel table) serves host-int callers, `decode_step`, only.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache.kivi_cache import nvq_canonical
from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving import sampling
from kivi_tpu_torch.utils.graphs import StepGraphs
from kivi_tpu_torch.utils.guards import checked_call

FILL_BUCKET = 512   # the decode fill bound's rounding (one graph per bucket)


def canonical_phase(qcfg: QuantConfig, prompt_len: int) -> int:
    """Canonicalize a token count to its quantization phase: flush
    schedules depend only on prompt_len mod lcm(W, v_flush) (plus the
    <= W edge)."""
    if not qcfg.quantize_kv:
        return 0
    if prompt_len > 0:
        W, vf = qcfg.residual_length, qcfg.value_flush
        L = W * vf // math.gcd(W, vf)
        if prompt_len > W + L:
            prompt_len = W + 1 + (prompt_len - W - 1) % L
    return prompt_len


def nkq_prefill(T: int, W: int) -> int:
    """Quantized-key count in prefill/extend-canonical state."""
    return (T // W) * W


def phase_period(qcfg: QuantConfig) -> int:
    """lcm(W, v_flush): chunk sizes that are a multiple of this keep
    every interior chunk of a chunked prefill on one phase."""
    W, vf = qcfg.residual_length, qcfg.value_flush
    return W * vf // math.gcd(W, vf)


def flush_schedule(qcfg: QuantConfig, prompt_len: int, steps: int) -> dict:
    """For a known prompt length, the decode steps at which the K / V
    windows are full: {step_index: (flush_k, flush_v)}, flushes to run
    BEFORE that step's append."""
    W, vf = qcfg.residual_length, qcfg.value_flush
    T = prompt_len
    i_k0 = W - (T - nkq_prefill(T, W))
    i_v0 = W - (T - nvq_canonical(T, W, vf))
    events = {}
    for i in range(steps):
        fk = i >= i_k0 and (i - i_k0) % W == 0
        fv = i >= i_v0 and (i - i_v0) % vf == 0
        if fk or fv:
            events[i] = (fk, fv)
    return events


def fill_bound(prompt_len: int, steps: int) -> int:
    """The static bound on the cache fill over a decode of `steps` tokens
    after a prompt of prompt_len, rounded up to FILL_BUCKET so that one
    graph serves many lengths (kivi_tpu/serving/engine.py:213)."""
    return -(-(prompt_len + steps) // FILL_BUCKET) * FILL_BUCKET


@dataclasses.dataclass
class _DecodeState:
    """What a captured decode step reads and writes, at fixed addresses:
    the caches (whose counters are rows of `counters` during a decode),
    the token fed and its RoPE position (B, 1) int64, the left pads (B,)
    int64, the penalty mask (B, V) bool (allocated on first use), the
    token buffer (B, max_seq_len) int32 and the step index (1,) int64
    into it.  `ptrs` identifies the caches' storage."""

    ptrs: tuple
    caches: list
    counters: Optional[torch.Tensor]
    token: torch.Tensor
    pos: torch.Tensor
    pad: torch.Tensor
    out: torch.Tensor
    step: torch.Tensor
    seen: Optional[torch.Tensor] = None


def _cache_ptrs(caches) -> tuple:
    return tuple(getattr(c, f.name).data_ptr() for c in caches
                 for f in dataclasses.fields(c)
                 if isinstance(getattr(c, f.name), torch.Tensor))


class Engine:
    """Generation engine over the KIVI cache, or over the fp16 cache when
    qcfg.quantize_kv is False (QuantConfig(16, 16, ...): the baseline).
    Runs on CUDA (the kernels; decode replayed as CUDA graphs) unless
    built with device="cpu" (the plain versions, run eagerly).
    debug=True: the same program run eagerly, every forward, flush and
    decode step a checked call (module docstring).

    params: the port's parameter dict (modeling.init_params or
    convert.params_from_jax), already on `device`."""

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, params: dict,
                 max_seq_len: int, batch_size: int, device=None,
                 cache_dtype=torch.bfloat16, debug: bool = False):
        self.cfg, self.qcfg, self.params = cfg, qcfg, params
        self.max_seq_len, self.batch_size = max_seq_len, batch_size
        self.device = modeling.resolve_device(device)
        self.cache_dtype = cache_dtype
        self.debug = debug
        self._forward = (checked_call(modeling.forward) if debug
                         else modeling.forward)
        self._caches = None   # the caches generate() prefills, reused
        self._dec: Optional[_DecodeState] = None
        self.graphs = (StepGraphs(self.device)
                       if self.device.type == "cuda" and not debug else None)

    def init_caches(self):
        return modeling.init_caches(self.cfg, self.qcfg, self.batch_size,
                                    self.max_seq_len, self.cache_dtype,
                                    self.device)

    def own_caches(self):
        """The engine's own caches, those generate() prefills: allocated
        once and cleared on every call, so that the decode graphs
        captured over them are replayed by the next call (the JAX engine
        donates its caches instead).  A caller holding them sees them
        overwritten by the next call."""
        if self._caches is None:
            self._caches = self.init_caches()
        else:
            for c in self._caches:
                KC.clear(c)
        return self._caches

    def _pad(self, pad_lens, B: int) -> Optional[torch.Tensor]:
        if pad_lens is None:
            return None
        return torch.as_tensor(pad_lens, dtype=torch.int64,
                               device=self.device).reshape(B)

    def _prefill(self, tokens: torch.Tensor, caches=None, pad_lens=None):
        """One-shot prefill of a prompt (B, T), LEFT-padded by pad_lens
        (B,) slots per row: exact attention over the whole prompt, then
        the cache ingest.  RoPE positions are the true token indices,
        max(i - pad, 0).  Returns (last-token logits (B, V) f32,
        caches)."""
        tokens = tokens.to(self.device)
        B, T = tokens.shape
        pad = self._pad(pad_lens, B)
        if caches is None:
            caches = self.init_caches()
        positions = torch.arange(T, device=self.device).expand(B, T)
        if pad is not None:
            positions = torch.clamp(positions - pad[:, None], min=0)
        logits, caches = self._forward(
            self.params, tokens, caches, self.cfg, self.qcfg, positions,
            mode="prefill", last_only=True, pad_len=pad)
        return logits[:, -1], caches

    def prefill(self, tokens: torch.Tensor, caches=None, pad_lens=None):
        """One-shot prefill of tokens (B, T), LEFT-padded by pad_lens (B,)
        slots per row (None = no padding).  Returns (greedy next token
        (B, 1) int32, caches)."""
        logits, caches = self._prefill(tokens, caches, pad_lens)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], caches

    def prefill_chunked(self, tokens: torch.Tensor, chunk_size: int = 512,
                        caches=None, pad_lens=None):
        """Prefill a prompt (B, T), LEFT-padded by pad_lens (B,) slots per
        row, in fixed-size chunks through the extend path.  Over a KIVI
        cache the chunk is rounded up to a multiple of phase_period so
        every interior chunk sits on one quantization phase; the fp cache
        takes the chunk as given.  Returns (last-token logits (B, V) f32,
        caches)."""
        if self.qcfg.quantize_kv:
            L = phase_period(self.qcfg)
            if chunk_size % L:
                chunk_size += L - chunk_size % L
        tokens = tokens.to(self.device)
        B, T = tokens.shape
        pad = self._pad(pad_lens, B)
        if caches is None:
            caches = self.init_caches()
        logits = None
        for t0 in range(0, T, chunk_size):
            chunk = tokens[:, t0:t0 + chunk_size]
            T1 = chunk.shape[1]
            positions = (t0 + torch.arange(T1, device=self.device)
                         ).expand(B, T1)
            if pad is not None:
                positions = torch.clamp(positions - pad[:, None], min=0)
            logits, caches = self._forward(
                self.params, chunk, caches, self.cfg, self.qcfg, positions,
                mode="extend", last_only=True, pad_len=pad, prev_len=t0)
        return logits[:, -1], caches

    def decode_step(self, token: torch.Tensor, pos: torch.Tensor, caches,
                    pad_lens=None, flush: bool = True):
        """token (B, 1) int; pos (B, 1) RoPE position of `token`.  Returns
        (logits (B, V) f32, caches).  flush=True checks the windows
        before the append; the decode loop flushes on its schedule
        instead."""
        B = token.shape[0]
        logits, caches = self._forward(
            self.params, token, caches, self.cfg, self.qcfg, pos,
            mode="decode", flush=flush, pad_len=self._pad(pad_lens, B))
        return logits[:, -1], caches

    def decode(self, first: torch.Tensor, pos: torch.Tensor, caches, *,
               steps: int, prompt_len: int, pad_lens=None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               repetition_penalty: float = 1.0,
               seen: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Generate `steps` tokens after `first` (B, 1), whose RoPE
        position is pos (B, 1); the caches (host-int counters) hold
        prompt_len tokens.  A KIVI cache's window flushes run on the
        static schedule between steps; the fp cache has none.  Returns
        (tokens (B, steps) int32, caches), the caches updated in place
        with host-int counters again."""
        # a host int: the flush schedule and the fill bound both stand on it
        assert caches[0].seq_len == prompt_len, (
            f"the caches hold {caches[0].seq_len} tokens, not prompt_len "
            f"{prompt_len}")
        events = (flush_schedule(self.qcfg,
                                 canonical_phase(self.qcfg, prompt_len),
                                 steps)
                  if self.qcfg.quantize_kv else {})
        use_pen = repetition_penalty != 1.0 and seen is not None
        fb = fill_bound(prompt_len, steps)
        st = self._decode_begin(first, pos, caches, pad_lens,
                                seen if use_pen else None)
        penalty = repetition_penalty if use_pen else 1.0
        has_pad = pad_lens is not None
        body = functools.partial(self._decode_body, st, fb, has_pad,
                                 temperature, top_k, top_p, penalty,
                                 generator)
        flush = modeling.flush_caches
        if self.debug:
            body, flush = checked_call(body), checked_call(flush)
        # the JAX jit's static arguments but `steps` (the graph is one
        # step); the generator object itself, since a graph draws from
        # the generator it was captured with
        key = (first.shape[0], fb, has_pad, temperature, top_k, top_p,
               penalty, generator if temperature > 0 else None)
        gens = (generator,) if temperature > 0 and generator is not None \
            else ()
        for i in range(steps):
            if i in events:
                fk, fv = events[i]
                flush(caches, self.qcfg, k=fk, v=fv)
            if self.graphs is not None:
                self.graphs.run(key, body, gens)
            else:
                body()
        return self._decode_end(st, steps), caches

    def _decode_begin(self, first, pos, caches, pad_lens,
                      seen) -> _DecodeState:
        """Move the caches' counters to the device and load the step's
        inputs into the decode state of these caches (made anew, and the
        graphs dropped, when the caches are not the last ones')."""
        B = first.shape[0]
        ptrs = _cache_ptrs(caches)
        st = self._dec
        if st is None or st.ptrs != ptrs:
            if self.graphs is not None:
                self.graphs.clear()

            def z(*shape, dt=torch.int64):
                return torch.zeros(shape, dtype=dt, device=self.device)

            st = self._dec = _DecodeState(
                ptrs=ptrs, caches=caches, counters=None, token=z(B, 1),
                pos=z(B, 1), pad=z(B), out=z(B, self.max_seq_len,
                                            dt=torch.int32), step=z(1))
        st.caches = caches
        cm = KC if self.qcfg.quantize_kv else FC
        st.counters = cm.counters_to_device(caches, st.counters)
        st.token.copy_(first.reshape(B, 1))
        st.pos.copy_(torch.as_tensor(pos).reshape(B, 1))
        if pad_lens is not None:
            st.pad.copy_(self._pad(pad_lens, B))
        if seen is not None:
            if st.seen is None:
                st.seen = torch.zeros(seen.shape, dtype=torch.bool,
                                      device=self.device)
            st.seen.copy_(seen)
        st.step.zero_()
        return st

    def _decode_body(self, st: _DecodeState, fill_bound: int,
                     has_pad: bool, temperature: float, top_k: int,
                     top_p: float, penalty: float,
                     generator: Optional[torch.Generator]) -> None:
        """One plain decode step, the body a CUDA graph captures: reads
        and writes only the state's tensors, in place."""
        logits, _ = modeling.forward(
            self.params, st.token, st.caches, self.cfg, self.qcfg, st.pos,
            mode="decode", flush=False, pad_len=st.pad if has_pad else None,
            fill_bound=fill_bound)
        logits = logits[:, -1]
        if penalty != 1.0:
            # the consumed token joins the sequence before the penalty
            st.seen.scatter_(1, st.token, True)
            logits = sampling.apply_repetition_penalty(logits, st.seen,
                                                       penalty)
        nxt = sampling.sample_step(logits, generator,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p)
        st.out.index_copy_(1, st.step, nxt[:, None])
        st.step += 1
        st.token.copy_(nxt[:, None])
        st.pos += 1

    def _decode_end(self, st: _DecodeState, steps: int) -> torch.Tensor:
        """The counters back to host ints (one read); the tokens."""
        cm = KC if self.qcfg.quantize_kv else FC
        cm.counters_to_host(st.caches, st.counters)
        return st.out[:, :steps].clone()

    def generate(self, tokens: torch.Tensor, max_new_tokens: int, *,
                 prefill_chunk_size: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, repetition_penalty: float = 1.0,
                 pad_lens=None,
                 generator: Optional[torch.Generator] = None,
                 prefix=None, suffix_lens=None) -> torch.Tensor:
        """Greedy/sampled generation: tokens (B, T) -> (B, max_new_tokens)
        int32.  tokens may be LEFT-padded (pad_lens (B,)); a batch
        smaller than batch_size is topped up with copies of the last row
        and the extras are dropped.  Rows past their EOS emit
        eos_token_id.

        Without prefill_chunk_size the prompt is prefilled one-shot
        (exact attention over the whole prompt); with it, in chunks
        through the extend path (earlier chunks seen quantized).
        prefix=, suffix_lens=, beam search and streaming come with later
        slices of the port."""
        if prefix is not None or suffix_lens is not None:
            raise NotImplementedError(
                "prefix snapshots and ragged suffixes come with a later "
                "slice of the port")
        tokens = torch.as_tensor(tokens, device=self.device)
        B, T = tokens.shape
        n_real = B
        if pad_lens is not None:
            pad_lens = torch.as_tensor(pad_lens, dtype=torch.int64,
                                       device=self.device).reshape(B)
        if B < self.batch_size:
            extra = self.batch_size - B
            tokens = torch.cat([tokens, tokens[-1:].expand(extra, T)])
            if pad_lens is not None:
                pad_lens = torch.cat([pad_lens, pad_lens[-1:].expand(extra)])
            B = self.batch_size
        assert B == self.batch_size
        assert T + max_new_tokens <= self.max_seq_len, "cache too small"

        caches = self.own_caches()
        if prefill_chunk_size is None:
            logits, caches = self._prefill(tokens, caches, pad_lens)
        else:
            logits, caches = self.prefill_chunked(
                tokens, prefill_chunk_size, caches, pad_lens)
        seen = None
        if repetition_penalty != 1.0:
            seen = sampling.seen_mask_from_prompt(
                tokens, self.cfg.vocab_size, pad_len=pad_lens)
            logits = sampling.apply_repetition_penalty(
                logits, seen, repetition_penalty)
        first = sampling.sample_step(logits, generator,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p)[:, None]
        pos = torch.full((B, 1), T, dtype=torch.int64, device=self.device)
        if pad_lens is not None:
            pos = pos - pad_lens[:, None]
        out = first
        if max_new_tokens > 1:
            rest, caches = self.decode(
                first, pos, caches, steps=max_new_tokens - 1, prompt_len=T,
                pad_lens=pad_lens, temperature=temperature, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty,
                seen=seen, generator=generator)
            out = torch.cat([first, rest], dim=1)
        out = out[:n_real]
        if eos_token_id is not None:
            hit = (out == eos_token_id).to(torch.int32)
            keep = (torch.cumsum(hit, dim=1) - hit) == 0   # before eos
            out = torch.where(keep, out,
                              torch.full_like(out, eos_token_id))
        return out
