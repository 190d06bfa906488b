"""Generation engine over the KIVI cache or the fp16 cache (the
baseline): port of the main-path subset of `kivi_tpu/serving/engine.py`
— one-shot prefill (`prefill`) or chunked prefill through the extend
path (`prefill_chunked`), then decode.

PyTorch runs eagerly, so the decode "scan" is a Python loop.  As in the
JAX engine, a KIVI cache's window flushes run unconditionally at the
steps the flush schedule fixes for the known prompt length, and the
per-step body does no flush checks (`decode_append(do_flush=False)`);
the fp cache has no flushes.  The cache counters are host ints, so no
step waits on the device to read them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kivi_tpu_torch.cache.kivi_cache import nvq_canonical
from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving import sampling


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


class Engine:
    """Generation engine over the KIVI cache, or over the fp16 cache when
    qcfg.quantize_kv is False (QuantConfig(16, 16, ...): the baseline).
    Runs on CUDA (the kernels) unless built with device="cpu" (the plain
    versions).

    params: the port's parameter dict (modeling.init_params or
    convert.params_from_jax), already on `device`."""

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, params: dict,
                 max_seq_len: int, batch_size: int, device=None,
                 cache_dtype=torch.bfloat16):
        self.cfg, self.qcfg, self.params = cfg, qcfg, params
        self.max_seq_len, self.batch_size = max_seq_len, batch_size
        self.device = modeling.resolve_device(device)
        self.cache_dtype = cache_dtype

    def init_caches(self):
        return modeling.init_caches(self.cfg, self.qcfg, self.batch_size,
                                    self.max_seq_len, self.cache_dtype,
                                    self.device)

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
        logits, caches = modeling.forward(
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
            logits, caches = modeling.forward(
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
        logits, caches = modeling.forward(
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
        position is pos (B, 1); the cache holds prompt_len tokens.
        A KIVI cache's window flushes run on the static schedule between
        steps; the fp cache has none.  Returns (tokens (B, steps) int32,
        caches)."""
        events = (flush_schedule(self.qcfg,
                                 canonical_phase(self.qcfg, prompt_len),
                                 steps)
                  if self.qcfg.quantize_kv else {})
        use_pen = repetition_penalty != 1.0 and seen is not None
        token, out = first, []
        for i in range(steps):
            if i in events:
                fk, fv = events[i]
                modeling.flush_caches(caches, self.qcfg, k=fk, v=fv)
            logits, caches = self.decode_step(token, pos, caches, pad_lens,
                                              flush=False)
            if use_pen:
                seen = sampling.update_seen(seen, token[:, 0])
                logits = sampling.apply_repetition_penalty(
                    logits, seen, repetition_penalty)
            nxt = sampling.sample_step(logits, generator,
                                       temperature=temperature,
                                       top_k=top_k, top_p=top_p)
            out.append(nxt)
            token, pos = nxt[:, None], pos + 1
        return torch.stack(out, dim=1), caches

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

        if prefill_chunk_size is None:
            logits, caches = self._prefill(tokens, pad_lens=pad_lens)
        else:
            logits, caches = self.prefill_chunked(
                tokens, prefill_chunk_size, pad_lens=pad_lens)
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
