"""Batched speculative decoding over continuous-batching slots: port of
`kivi_tpu/serving/spec_batcher.py`.

Every step, all active slots draft k tokens in one batched scan and
verify them in one batched width-(k+1) extend; acceptance, positions,
window phases and flush boundaries all diverge per slot.  Per-slot
greedy output is the plain batcher's (hence the engine's) greedy stream
for any draft model.  The boundary discipline of serving/speculative.py
holds per slot:

  * eager boundary flushes: the masked flushes
    (`kivi_cache.flush_k_masked` / `flush_v_masked`, through the
    in-place quantizers), each slot flushing when it is active and its
    window holds W tokens;
  * the block clamp keff_s = min(k, cap_k - 1, cap_v - 1), computed on
    the host from mirrored watermarks (exact: the masked flushes apply
    the rule the mirror simulates) and copied to the device;
  * window-only ingest, so rejection is a per-row counter rollback.

The draft scan runs k+1 steps: the last appends the final proposal's
K/V, so a full accept needs no bonus step.  A step is two bodies, each
updating its state in place and reading nothing back: the masked
flushes plus the (k+1)-step draft scan, and the verify with the accept
on the device (the Leviathan accept-reject for sampled slots,
`spec_accept_device`; a greedy prefix match, its temperature -> 0
limit, when no slot samples), the counter rollback and the next token
and position.  On CUDA each is a CUDA graph per (fill bound, sampled)
key (utils/graphs.py), as the base batcher's decode step is; the host
reads one (S, k+2) block of emitted tokens and accepted counts a step.
Sampled draws are Gumbel-max from `torch.rand` with the batcher's
generator (`torch.multinomial` syncs).  No repetition penalty, prefixes,
or chunked admission (plain bucketed prefill), as in the JAX batcher.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache.kivi_cache import nvq_canonical
from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving import sampling
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from kivi_tpu_torch.serving.engine import FILL_BUCKET, nkq_prefill
from kivi_tpu_torch.serving.speculative import (flush_boundaries,
                                                rollback_caches, run_step)
from kivi_tpu_torch.utils.guards import GuardError


def spec_accept_device(p: torch.Tensor, q: torch.Tensor, xs: torch.Tensor,
                       keff: torch.Tensor,
                       generator=None):
    """Leviathan accept-reject for S slots' blocks on the device: the
    torch twin of speculative.spec_accept (kivi_tpu/serving/
    spec_batcher.py:60-97, here batched over a leading slot axis).

    p (S, k+1, V) target distributions; q (S, k, V) draft distributions;
    xs (S, k) draft tokens; keff (S,) accept caps.  Accept x_i with prob
    min(1, p_i(x)/q_i(x)) for i < keff; the first rejection at j emits a
    sample of normalize(max(p_j - q_j, 0)); surviving to j == keff emits
    the bonus sample from p_keff.  Greedy slots (one-hot p, q) reduce to
    a prefix match with argmax corrections.  Draws: U(0,1) and Gumbel-max
    categoricals from `generator`.  Returns (emitted (S, k+1), j (S,));
    emitted past j is garbage."""
    S, k = xs.shape
    xs = xs.to(torch.int64)
    ii = torch.arange(k, device=p.device)
    px = p[:, :k].gather(2, xs[..., None])[..., 0]
    qx = q.gather(2, xs[..., None])[..., 0]
    us = torch.rand((S, k), generator=generator, device=p.device)
    acc = us < torch.clamp(px / torch.clamp(qx, min=1e-20), max=1.0)
    rej = (~(acc & (ii < keff.reshape(S, 1)))).to(torch.int32)
    j = torch.where(rej.any(1), rej.argmax(1), k)
    # residual samples at every position (only row j is consumed)
    r = torch.clamp(p[:, :k] - q, min=0.0)
    rs = r.sum(-1, keepdim=True)
    rdist = torch.where(rs > 1e-12, r / torch.clamp(rs, min=1e-20),
                        p[:, :k])
    V = p.shape[-1]
    rtok = sampling.gumbel_argmax(torch.log(torch.clamp(
        rdist, min=1e-30)).reshape(S * k, V), generator).reshape(S, k)
    btok = sampling.gumbel_argmax(torch.log(torch.clamp(
        p, min=1e-30)).reshape(S * (k + 1), V), generator).reshape(S, k + 1)
    final = torch.where(j < keff.reshape(S),
                        rtok.gather(1, j.clamp(max=k - 1)[:, None])[:, 0],
                        btok.gather(1, j[:, None])[:, 0])
    emitted = torch.where(
        torch.arange(k + 1, device=p.device) < j[:, None],
        torch.cat([xs, torch.zeros_like(xs[:, :1])], dim=1), final[:, None])
    return emitted, j


class SpeculativeBatcher(ContinuousBatcher):
    """ContinuousBatcher whose step is a speculative iteration: each
    active slot emits 1..k+1 tokens a step.

    dcfg/dqcfg/dparams: the draft model (fewer layers, or the same
    weights over another cache; correctness never depends on it), its
    weights on the batcher's device.  k: speculation depth.  Runs on
    CUDA (each step two graph replays) unless built with device="cpu";
    debug=True runs the same bodies eagerly as checked calls and checks
    the host's watermark mirror against the device counters."""

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, params,
                 dcfg: ModelConfig, dqcfg: QuantConfig, dparams,
                 num_slots: int, max_seq_len: int, k: int = 4,
                 device=None,
                 prompt_buckets=(128, 256, 512, 1024, 2048, 4096),
                 cache_dtype=torch.bfloat16, debug: bool = False):
        modeling.reject_rings(dcfg, "SpeculativeBatcher's draft")
        super().__init__(cfg, qcfg, params, num_slots, max_seq_len,
                         device=device, prompt_buckets=prompt_buckets,
                         cache_dtype=cache_dtype, debug=debug)
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        self.dcfg, self.dqcfg, self.dparams, self.k = dcfg, dqcfg, dparams, k
        S, dev = num_slots, self.device
        self.d_caches = modeling.init_slot_caches(dcfg, dqcfg, S,
                                                  max_seq_len, cache_dtype,
                                                  dev)
        self._d_one = modeling.init_caches(dcfg, dqcfg, 1, max_seq_len,
                                           cache_dtype, dev)
        # the host mirror of the quantized watermarks per slot (exact: the
        # masked flushes apply the n_win == W rule it simulates); the
        # committed cache tokens per slot are the base batcher's `fill`
        self.wm = {m: {"nkq": np.zeros(S, np.int64),
                       "nvq": np.zeros(S, np.int64)}
                   for m in ("target", "draft")}
        self._host_temp = np.zeros(S, np.float64)   # sampled-mode switch
        # iterations (steps), accepted draft tokens and clamped blocks
        # summed over active slots, and slot_steps: active slots summed
        # over steps (accepted / slot_steps = mean accepted a block)
        self.stats = {"iterations": 0, "accepted": 0, "clamped": 0,
                      "slot_steps": 0}

        # the step's device state, at fixed addresses: the committed
        # count n (S,), the clamp keff (S,), the draft's proposals and
        # (sampled) distributions, and the harvest block [emitted | j]
        def z(*shape, dt=torch.int64):
            return torch.zeros(shape, dtype=dt, device=dev)

        self.n_dev, self.keff_dev = z(S), z(S)
        self.d_toks = z(S, k + 1)
        self.q_probs = None            # (S, k+1, V) f32, on first sampled use
        self.res = z(S, k + 2)

    # -- device work ----------------------------------------------------------

    def _draft_prefill(self, prompt: List[int], bucket: int) -> None:
        """The draft's one-shot prefill of a prompt LEFT-padded to bucket
        into the reused batch-1 draft cache."""
        pad = bucket - len(prompt)
        toks = torch.tensor([[0] * pad + prompt], dtype=torch.int64,
                            device=self.device)
        padv = torch.tensor([pad], dtype=torch.int64, device=self.device)
        for c in self._d_one:
            KC.clear(c)
        positions = torch.clamp(torch.arange(bucket, device=self.device)
                                - pad, min=0)[None]
        self._forward(self.dparams, toks, self._d_one, self.dcfg,
                      self.dqcfg, positions, mode="prefill", last_only=True,
                      pad_len=padv)

    def _spec_draft(self, fb: int, sampled: bool) -> None:
        """Body one: every active slot's boundary flushes (target and
        draft), then k+1 draft steps with window-only ingest, inactive
        slots frozen.  Greedy slots take the argmax; sampled slots draw
        from their warped distribution, kept in q_probs (greedy slots'
        one-hot there)."""
        act = self.act_dev
        flush_boundaries(self.caches, self.qcfg, act)
        flush_boundaries(self.d_caches, self.dqcfg, act)
        tok = self.cur_tok
        for i in range(self.k + 1):
            logits, _ = modeling.forward(
                self.dparams, tok, self.d_caches, self.dcfg, self.dqcfg,
                self.pos + i, mode="decode", pad_len=self.pad_dev,
                active=act, fill_bound=fb, ingest="window")
            lg = logits[:, -1]
            greedy = torch.argmax(lg, dim=-1)
            if sampled:
                warped = sampling.warp_logits_per_row(
                    lg, self.temp_dev, self.topk_dev, self.topp_dev)
                cold = (self.temp_dev <= 0.0)[:, None]
                hot = torch.nn.functional.one_hot(greedy, lg.shape[-1])
                self.q_probs[:, i].copy_(torch.where(
                    cold, hot.to(torch.float32),
                    torch.softmax(warped, dim=-1)))
                greedy = torch.where(cold[:, 0], greedy,
                                     sampling.gumbel_argmax(warped,
                                                            self.gen))
            self.d_toks[:, i].copy_(greedy)
            tok = self.d_toks[:, i:i + 1]

    def _spec_verify(self, sampled: bool) -> None:
        """Body two: the target's width-(k+1) extend over [cur, k
        proposals] with window-only ingest, the accept on the device (the
        greedy prefix match, or spec_accept_device over the per-slot
        distributions), the rollback of both models' counters to each
        slot's committed count, the next token and position, and the
        harvest block res = [emitted (k+1) | j]."""
        k, act = self.k, self.act_dev
        vin = torch.cat([self.cur_tok, self.d_toks[:, :k]], dim=1)
        positions = self.pos + torch.arange(k + 1, device=self.device)
        logits, _ = modeling.forward(
            self.params, vin, self.caches, self.cfg, self.qcfg, positions,
            mode="extend", last_only=False, pad_len=self.pad_dev,
            active=act, ingest="window")
        if sampled:
            S, T1, V = logits.shape

            def rep(x):
                return x.repeat_interleave(T1)

            p = sampling.probs_per_row(
                logits.reshape(S * T1, V), rep(self.temp_dev),
                rep(self.topk_dev), rep(self.topp_dev)).reshape(S, T1, V)
            emitted, j = spec_accept_device(p, self.q_probs[:, :k],
                                            self.d_toks[:, :k],
                                            self.keff_dev, self.gen)
        else:
            t_pred = torch.argmax(logits, dim=-1)              # (S, k+1)
            mism = (t_pred[:, :k] != self.d_toks[:, :k]).to(torch.int32)
            j = torch.minimum(torch.where(mism.any(1), mism.argmax(1), k),
                              self.keff_dev)
            emitted = torch.where(
                torch.arange(k + 1, device=self.device) < j[:, None],
                self.d_toks, t_pred.gather(1, j[:, None]))
        step = (j + 1) * act
        n_new = self.n_dev + step
        rollback_caches(self.caches + self.d_caches, n_new, act)
        self.n_dev.copy_(n_new)
        self.cur_tok.copy_(torch.where(act[:, None],
                                       emitted.gather(1, j[:, None]),
                                       self.cur_tok))
        self.pos += step[:, None]
        self.res[:, :k + 1].copy_(emitted)
        self.res[:, k + 1].copy_(j)

    # -- host side ------------------------------------------------------------

    def submit(self, req: Request):
        if req.repetition_penalty != 1.0:
            raise ValueError("SpeculativeBatcher does not support "
                             "repetition penalty (it conditions on the "
                             "full emitted sequence, which diverges "
                             "per-slot mid-block)")
        if req.prefix_tokens is not None:
            raise ValueError("SpeculativeBatcher does not take prefixes")
        # a slot commits up to k+1 tokens a step, so the last step may
        # overshoot the emitted count by up to k: reserve that headroom
        # so that no slot's cap reaches 0
        bucket = self._bucket_for(len(req.prompt))
        if (bucket is None
                or bucket + req.max_new_tokens + self.k > self.T):
            raise ValueError(
                f"prompt bucket + max_new_tokens + k exceeds "
                f"max_seq_len ({self.T}) — request cannot run "
                f"speculatively without overflowing its slot cache")
        super().submit(req)

    def _wm_reset(self, slot: int, T0: int):
        for m, q in (("target", self.qcfg), ("draft", self.dqcfg)):
            if q.quantize_kv:
                W, vf = q.residual_length, q.value_flush
                self.wm[m]["nkq"][slot] = nkq_prefill(T0, W)
                self.wm[m]["nvq"][slot] = nvq_canonical(T0, W, vf)

    def _admit(self):
        """The base bucketed admission for the target, then each newly
        admitted slot mirrored into the draft caches and the watermarks."""
        prev = self.active.copy()
        super()._admit()
        for s in np.flatnonzero(self.active & ~prev):
            s = int(s)
            req = self.slot_req[s]
            prompt = [int(t) for t in req.prompt]
            bucket = self._bucket_for(len(prompt))
            self._draft_prefill(prompt, bucket)
            for big, one in zip(self.d_caches, self._d_one):
                KC.write_slot(big, s, one)
            self._wm_reset(s, bucket)
            self.n_dev[s] = bucket
            self._host_temp[s] = req.temperature

    def _caps(self, who: str, qcfg: QuantConfig) -> np.ndarray:
        """Per-slot post-flush window headroom, updating the host
        watermark mirror by the n_win == W rule the device flush
        applies."""
        n = self.fill
        if not qcfg.quantize_kv:
            return self.T - n
        W, vf = qcfg.residual_length, qcfg.value_flush
        wm = self.wm[who]
        fk = self.active & (n - wm["nkq"] == W)
        wm["nkq"][fk] += W
        fv = self.active & (n - wm["nvq"] == W)
        wm["nvq"][fv] += vf
        return W - np.maximum(n - wm["nkq"], n - wm["nvq"])

    def _check_mirror(self) -> None:
        """debug=True: after the boundary flushes every active slot's
        quantized watermarks on the device equal the mirror's, and its
        committed count the host's."""
        act = self.active
        got = [self.n_dev.cpu().numpy()[act]]
        want = [self.fill[act]]
        for who, caches, q in (("target", self.caches, self.qcfg),
                               ("draft", self.d_caches, self.dqcfg)):
            if q.quantize_kv:
                for f in ("nkq", "nvq"):
                    name = "n_k_quant" if f == "nkq" else "n_v_quant"
                    got.append(getattr(caches[0], name).cpu().numpy()[act])
                    want.append(self.wm[who][f][act])
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise GuardError(f"watermark mirror {want} != the device's "
                             f"{got}")

    def step(self):
        """Admit, run one speculative iteration (two bodies), harvest
        each active slot's accepted block."""
        self._retire()
        self._admit()
        if not self.active.any():
            return
        k = self.k
        cap_t = self._caps("target", self.qcfg)
        cap_d = self._caps("draft", self.dqcfg)
        # the lower clamp: cap == 0 (a slot at capacity) must not drive
        # keff to -1; submit() refuses requests that could reach it
        keff = np.maximum(np.minimum(k, np.minimum(cap_t, cap_d) - 1), 0)
        self.keff_dev.copy_(torch.from_numpy(keff))
        sampled = bool((self._host_temp[self.active] > 0).any())
        if sampled and self.q_probs is None:
            self.q_probs = torch.zeros((self.S, k + 1, self.cfg.vocab_size),
                                       dtype=torch.float32,
                                       device=self.device)
        # the fill bound covers the ACTIVE slots' k+1 appends (the base
        # batcher's invariant: an inactive slot's output is never read)
        fb = int(min(-(-(int(self.fill[self.active].max()) + k + 1)
                       // FILL_BUCKET) * FILL_BUCKET, self.T))
        run_step(self.graphs, self.debug, ("spec-draft", fb, sampled),
                 functools.partial(self._spec_draft, fb, sampled),
                 (self.gen,))
        if self.debug:
            self._check_mirror()
        run_step(self.graphs, self.debug, ("spec-verify", sampled),
                 functools.partial(self._spec_verify, sampled), (self.gen,))
        res = self.res.cpu().numpy()                 # the step's one read
        self.stats["iterations"] += 1
        for s in np.flatnonzero(self.active):
            j = int(res[s, k + 1])
            self.fill[s] += j + 1
            self.stats["slot_steps"] += 1
            self.stats["accepted"] += j
            if int(keff[s]) < k:
                self.stats["clamped"] += 1
            req = self.slot_req[s]
            if req is None:
                continue
            out = self.slot_out[s]
            block = [int(t) for t in res[s, :j + 1]]
            block = block[:req.max_new_tokens - len(out)]
            if (req.eos_token_id is not None
                    and req.eos_token_id in block):
                block = block[:block.index(req.eos_token_id) + 1]
            out.extend(block)
            if req.on_token is not None:
                for t in block:
                    req.on_token(t)
