"""Speculative decoding: draft-model proposals, one-pass target verify.
Port of `kivi_tpu/serving/speculative.py`.

A small draft model proposes `k` tokens, the target scores all of them
(plus a bonus position) in ONE width-(k+1) extend forward, and the
longest matching prefix is accepted (Leviathan et al., arXiv:2211.17192,
greedy variant), so the greedy stream is the target engine's own for
any draft.  Sampled mode runs the accept-reject rule over the HF warper
chain, whose emitted marginal is the target's.

Flush-boundary discipline (the JAX module's docstring has the full
argument).  A width-(k+1) verify attends the block-START cache state at
every position, so a flush inside the block would make it differ from
sequential decode.  Three rules keep the block's sequential twin
flush-free:

  * eager boundary flush: at an iteration's start, a window holding W
    committed tokens is flushed, when sequential decode would flush it
    (a host mirror of the quantized watermarks says when, exactly);
  * block clamp: at most keff = min(k, cap_t - 1, cap_d - 1) draft
    tokens are accepted, cap being each model's post-flush window
    headroom;
  * window-only ingest (`forward(ingest="window")`,
    `kivi_cache.window_append_capped`): the draft steps and the verify
    append K/V to the fp windows only, so rejecting a block's tail is a
    counter rollback (`kivi_cache.rollback_counters`,
    `fp_cache.rollback`).

The JAX package compiles each piece once; the port runs each as a step
over device counters (the caches' counters moved to the device for the
generation, `counters_to_device`) and, on CUDA, captures each once as a
CUDA graph per static key and replays it (utils/graphs.py): the k-step
draft scan, the width-(k+1) verify, the draft's bonus step after a full
accept, and the rollback.  The host reads the draft's tokens and the
target's predictions once an iteration (the JAX host loop reads them
too) and computes the clamp from its watermark mirror.
`generate_device` replays one graph an iteration (masked flushes, k+1
draft steps, verify, greedy accept on the device, rollback, the output
written at the device count) and reads one (count, done) pair after
each: the JAX `lax.while_loop` has no host round trip at all.  The
verify is the extend kernel's per-row entry (`core.attention.
extend_attention` over device counters); the draft's decode is the
per-row decode kernels.  Engines built with debug=True run every step
eagerly as a checked call, and check the watermark mirror against the
device counters after every boundary flush.

Over tensor parallel (target and draft built with `Engine(mesh=)` on one
DeviceMesh, whose data axis is 1: batch 1), every rank of the model
group runs this same host loop.  Each forward is the engine's own
(`Engine._model`, the model group's collectives), whose logits are
gathered over the whole vocabulary, so every rank sees the same
predictions and decides the same acceptance (sampled: from identically
seeded generators); the boundary flushes and the rollbacks act on each
rank's own head shard of the caches, whose counters are the same on
every rank.  The JAX engine reaches the same tokens over sharded params
(tests/test_torch_spec_tp.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache.kivi_cache import nvq_canonical
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving import sampling
from kivi_tpu_torch.serving.engine import Engine, fill_bound, nkq_prefill
from kivi_tpu_torch.utils.graphs import StepGraphs
from kivi_tpu_torch.utils.guards import GuardError, checked_call


def spec_accept(p: np.ndarray, q: np.ndarray, xs: np.ndarray,
                us: np.ndarray, rng: np.random.Generator) -> list:
    """Leviathan et al. accept-reject over one speculative window (the
    JAX package's function, in numpy).

    p: (k+1, V) target sampling probabilities; q: (k, V) draft
    probabilities; xs: (k,) draft tokens; us: (k,) U(0,1) draws.  Token
    i is accepted with prob min(1, p_i(x)/q_i(x)); the first rejection
    emits a sample from normalize(max(p_i - q_i, 0)); full acceptance
    emits a bonus sample from p_k.  The emitted-token marginal equals
    sampling directly from p."""
    k = len(xs)
    for i in range(k):
        x = int(xs[i])
        if us[i] < min(1.0, float(p[i, x]) / max(float(q[i, x]), 1e-20)):
            continue
        r = np.maximum(p[i] - q[i], 0.0)
        s = float(r.sum())
        dist = r / s if s > 1e-12 else p[i] / float(p[i].sum())
        return [int(t) for t in xs[:i]] + [int(rng.choice(len(dist),
                                                          p=dist))]
    bonus = p[k] / float(p[k].sum())
    return [int(t) for t in xs] + [int(rng.choice(len(bonus), p=bonus))]


def rollback_caches(caches, n, active=None) -> None:
    """Every layer's counters back to n committed tokens (int, or a
    device tensor broadcast over the rows), in place; rows where active
    is false keep theirs."""
    for c in caches:
        if isinstance(c, FC.FpLayerCache):
            FC.rollback(c, n, active)
        else:
            KC.rollback_counters(c, n, active)


def run_step(graphs: Optional[StepGraphs], debug: bool, key, body,
             gens=()) -> None:
    """One step body: a checked call under debug, a replay of key's graph
    on CUDA (captured on first use), the body itself on the CPU."""
    if debug:
        checked_call(body)()
    elif graphs is not None:
        graphs.run(key, body, gens)
    else:
        body()


def flush_boundaries(caches, qcfg, active=None) -> None:
    """The masked boundary flushes over per-row device counters: each row
    flushes a window holding W tokens (and is active), no other."""
    if qcfg.quantize_kv:
        for c in caches:
            KC.flush_k_masked(c, qcfg, active)
            KC.flush_v_masked(c, qcfg, active)


@dataclasses.dataclass
class _SpecState:
    """What the captured steps read and write, at fixed addresses: the
    two models' counter buffers, the token fed to the draft and its
    position (1, 1) int64 (= the committed count N), the rollback target
    n (1,) int64, the draft's proposals (1, k+1) int64 and, sampled,
    their distributions (1, k+1, V) f32; the target's predictions (1,
    k+1) int64 or, sampled, distributions (1, k+1, V) f32; for
    generate_device the output buffer (L,) int32, its count (1,) int64,
    the done flag (1,) bool and the EOS id (1,) int64."""

    t_ctr: Optional[torch.Tensor]
    d_ctr: Optional[torch.Tensor]
    cur: torch.Tensor
    pos: torch.Tensor
    n: torch.Tensor
    d_toks: torch.Tensor
    t_pred: torch.Tensor
    q: Optional[torch.Tensor] = None
    p: Optional[torch.Tensor] = None
    out: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None
    done: Optional[torch.Tensor] = None
    eos: Optional[torch.Tensor] = None


class SpeculativeEngine:
    """Speculative decoding over two `Engine`s sharing a vocabulary.

    target: the model whose greedy output is reproduced.
    draft:  a cheaper model (fewer layers, or the same weights over
            another cache); correctness never depends on it.
    k:      speculation depth (draft tokens proposed per iteration).

    Both engines must be batch_size=1 (the low-batch latency play), on
    one device and on one mesh (the same DeviceMesh object, or none):
    over tensor parallel every rank of the model group runs the same
    loop (module docstring); one engine may serve as both.  The
    generation runs in caches of the speculative engine's own, allocated
    on first use and cleared per call, so that its graphs are replayed
    by every later call.  debug=True on either engine runs every step
    eagerly as a checked call (module docstring)."""

    def __init__(self, target: Engine, draft: Engine, k: int = 8):
        for eng, role in ((target, "target"), (draft, "draft")):
            modeling.reject_rings(eng.cfg, f"SpeculativeEngine's {role}")
        if target.batch_size != 1 or draft.batch_size != 1:
            raise ValueError("speculative decoding is batch_size=1 only")
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        if target.device != draft.device:
            raise ValueError("target and draft must share a device")
        if target.mesh is not draft.mesh:
            raise ValueError("target and draft must share a mesh")
        self.target, self.draft, self.k = target, draft, k
        self.device = target.device
        self.debug = target.debug or draft.debug
        self.graphs = (StepGraphs(self.device)
                       if self.device.type == "cuda" and not self.debug
                       else None)
        self._st: Optional[_SpecState] = None
        self._t_caches = self._d_caches = None
        # boundary-discipline usage counters (tests + introspection)
        self.stats = {"boundary_flush_k": 0, "boundary_flush_v": 0,
                      "clamped": 0}
        self.last_acceptance: list = []
        self.last_keff: list = []

    # -- the steps (each one CUDA graph per key) ----------------------------

    def _state(self) -> _SpecState:
        if self._st is None:
            k, V = self.k, self.target.cfg.vocab_size

            def z(*shape, dt=torch.int64):
                return torch.zeros(shape, dtype=dt, device=self.device)

            self._st = _SpecState(
                t_ctr=None, d_ctr=None, cur=z(1, 1), pos=z(1, 1), n=z(1),
                d_toks=z(1, k + 1), t_pred=z(1, k + 1),
                q=z(1, k + 1, V, dt=torch.float32),
                p=z(1, k + 1, V, dt=torch.float32))
        return self._st

    def _run_step(self, key, body, gens=()) -> None:
        run_step(self.graphs, self.debug, key, body, gens)

    def _draft_steps(self, st: _SpecState, steps: int, fb: int,
                     warp: Optional[dict], gen) -> None:
        """`steps` draft decode steps with window-only ingest from st.cur
        at st.pos: proposals into st.d_toks and, sampled (warp = the
        static warper controls), the warped distributions into st.q."""
        drf = self.draft
        tok = st.cur
        for i in range(steps):
            logits, _ = drf._model(
                drf.params, tok, self._d_caches, drf.cfg, drf.qcfg,
                st.pos + i, mode="decode", fill_bound=fb, ingest="window")
            lg = logits[:, -1]
            if warp is None:
                nxt = torch.argmax(lg, dim=-1)
            else:
                warped = sampling.warp_logits(lg, **warp)
                st.q[:, i].copy_(torch.softmax(warped, dim=-1))
                nxt = sampling.gumbel_argmax(warped, gen)
            st.d_toks[:, i].copy_(nxt)
            tok = st.d_toks[:, i:i + 1]

    def _verify(self, st: _SpecState, warp: Optional[dict]) -> None:
        """The target's width-(k+1) extend over [cur, d_toks[:k]] with
        window-only ingest, every position's logits: greedy predictions
        into st.t_pred or, sampled, the warped distributions into st.p."""
        tgt, k = self.target, self.k
        vin = torch.cat([st.cur, st.d_toks[:, :k]], dim=1)
        positions = st.pos + torch.arange(k + 1, device=self.device)
        logits, _ = tgt._model(
            tgt.params, vin, self._t_caches, tgt.cfg, tgt.qcfg, positions,
            mode="extend", last_only=False, ingest="window")
        if warp is None:
            st.t_pred.copy_(torch.argmax(logits, dim=-1))
        else:
            st.p.copy_(torch.softmax(sampling.warp_logits(logits, **warp),
                                     dim=-1))

    def _bonus(self, st: _SpecState, fb: int) -> None:
        """One draft step fed the last proposal d_toks[k-1] at N + k, its
        logits dropped: after a full accept the draft holds all k+1
        committed tokens (the scan emits the proposal, never feeds it)."""
        drf, k = self.draft, self.k
        drf._model(drf.params, st.d_toks[:, k - 1:k], self._d_caches,
                   drf.cfg, drf.qcfg, st.pos + k, mode="decode",
                   fill_bound=fb, ingest="window")

    def _rollback(self, st: _SpecState) -> None:
        rollback_caches(self._t_caches, st.n)
        rollback_caches(self._d_caches, st.n)

    # -- host-side boundary discipline --------------------------------------

    def _check_capacity(self, prompt_len: int, max_new_tokens: int):
        """Refuse generations that could fill either cache: an iteration
        commits up to k+1 tokens, so the last one may overshoot the
        emitted count by up to k (kivi_tpu/serving/speculative.py:
        224-236)."""
        cap = min(self.target.max_seq_len, self.draft.max_seq_len)
        need = prompt_len + max_new_tokens + self.k
        if need > cap:
            raise ValueError(
                f"prompt_len ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) + k ({self.k}) = {need} exceeds "
                f"min(target, draft) max_seq_len = {cap}")

    @staticmethod
    def _wm_init(qcfg, prompt_len: int) -> dict:
        """Quantized watermarks right after prefill (keys flushed at every
        full W, values vf-aligned)."""
        if not qcfg.quantize_kv:
            return {}
        W, vf = qcfg.residual_length, qcfg.value_flush
        return {"nkq": nkq_prefill(prompt_len, W),
                "nvq": nvq_canonical(prompt_len, W, vf)}

    def _sync_boundary(self, eng: Engine, caches, wm: dict, N: int) -> int:
        """Eager boundary flushes of eng's caches, exactly when sequential
        decode would flush (a window holding W committed tokens at the
        step's start), then the window headroom that bounds this
        iteration's block.  Under debug the mirror is checked against
        the device counters."""
        q = eng.qcfg
        if not q.quantize_kv:
            return eng.max_seq_len - N
        W, vf = q.residual_length, q.value_flush
        if N - wm["nkq"] == W:
            eng._flush(caches, q, k=True)
            wm["nkq"] += W
            self.stats["boundary_flush_k"] += 1
        if N - wm["nvq"] == W:
            eng._flush(caches, q, v=True)
            wm["nvq"] += vf
            self.stats["boundary_flush_v"] += 1
        if self.debug:
            c = caches[0]
            got = [int(c.n_k_quant[0]), int(c.n_v_quant[0]),
                   int(c.seq_len[0])]
            if got != [wm["nkq"], wm["nvq"], N]:
                raise GuardError(
                    f"watermark mirror (n_k_quant, n_v_quant, tokens) "
                    f"{[wm['nkq'], wm['nvq'], N]} != the device's {got}")
        return W - max(N - wm["nkq"], N - wm["nvq"])

    def _prefill_both(self, tokens, max_new_tokens: int):
        """Prefill target and draft into their own caches; move both
        caches' counters to the state's device buffers.  Returns (the
        target's last logits (1, V), the prompt length, the state)."""
        tgt, drf = self.target, self.draft
        tokens = torch.as_tensor(tokens, device=self.device).reshape(1, -1)
        tokens = tokens.to(torch.int64)
        Tp = tokens.shape[1]
        self._check_capacity(Tp, max_new_tokens)
        if self._t_caches is None:
            self._t_caches, self._d_caches = (tgt.init_caches(),
                                              drf.init_caches())
        for c in self._t_caches + self._d_caches:
            KC.clear(c)
        t_logits, _ = tgt._prefill(tokens, self._t_caches)
        drf._prefill(tokens, self._d_caches)
        st = self._state()
        st.t_ctr = (KC if tgt.qcfg.quantize_kv else FC).counters_to_device(
            self._t_caches, st.t_ctr)
        st.d_ctr = (KC if drf.qcfg.quantize_kv else FC).counters_to_device(
            self._d_caches, st.d_ctr)
        return t_logits, Tp, st

    def _counters_home(self, st: _SpecState) -> None:
        """Both caches' counters back to host ints (one read each)."""
        for eng, caches, buf in ((self.target, self._t_caches, st.t_ctr),
                                 (self.draft, self._d_caches, st.d_ctr)):
            (KC if eng.qcfg.quantize_kv else FC).counters_to_host(caches,
                                                                  buf)

    # -- device-resident loop ------------------------------------------------

    def _device_body(self, st: _SpecState, fb: int, has_eos: bool) -> None:
        """One whole iteration, the body of generate_device's graph
        (kivi_tpu/serving/speculative.py:269-368): masked boundary
        flushes, the clamp from the counters, k+1 greedy draft steps (the
        last appends the final proposal, so a full accept needs no bonus
        step), the verify, the greedy accept, the output written at the
        device count, and the rollback."""
        tgt, drf, k = self.target, self.draft, self.k
        flush_boundaries(self._t_caches, tgt.qcfg)
        flush_boundaries(self._d_caches, drf.qcfg)

        def cap(eng, caches):
            c = caches[0]
            if isinstance(c, FC.FpLayerCache):
                return eng.max_seq_len - st.pos[0]
            return eng.qcfg.residual_length - torch.maximum(c.n_k_win,
                                                            c.n_v_win)

        keff = (torch.minimum(cap(tgt, self._t_caches),
                              cap(drf, self._d_caches)) - 1).clamp(0, k)
        self._draft_steps(st, k + 1, fb, None, None)
        self._verify(st, None)
        t_pred, d = st.t_pred[0], st.d_toks[0]
        mism = (t_pred[:k] != d[:k]).to(torch.int32)
        first = torch.where(mism.any(), mism.argmax(), k)
        j = torch.minimum(first, keff).reshape(1)
        ii = torch.arange(k + 1, device=self.device)
        emit = torch.where(ii < j, d, t_pred.gather(0, j))
        valid = ii <= j
        idx = st.count + ii
        st.out.scatter_(0, idx, torch.where(valid, emit.to(torch.int32),
                                            st.out.gather(0, idx)))
        if has_eos:
            st.done |= (valid & (emit == st.eos)).any()
        st.n.copy_(st.pos[0] + j + 1)
        self._rollback(st)
        st.cur.copy_(t_pred.gather(0, j).reshape(1, 1))
        st.pos.copy_(st.n.reshape(1, 1))
        st.count += j + 1

    def generate_device(self, tokens, max_new_tokens: int,
                        eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy speculative generation with each iteration one replay
        (`_device_body`) and one (count, done) read after it.
        Token-equal to generate() greedy.  Returns (1, n) np.int32, n <=
        max_new_tokens, cut after the first EOS."""
        k = self.k
        t_logits, Tp, st = self._prefill_both(tokens, max_new_tokens)
        L = max_new_tokens + k + 2
        if st.out is None or st.out.numel() < L:
            st.out = torch.zeros(L, dtype=torch.int32, device=self.device)
            st.count = torch.zeros(1, dtype=torch.int64, device=self.device)
            st.done = torch.zeros(1, dtype=torch.bool, device=self.device)
            st.eos = torch.zeros(1, dtype=torch.int64, device=self.device)
            if self.graphs is not None:
                self.graphs.clear()
        cur = torch.argmax(t_logits, dim=-1)
        st.out.zero_()
        st.out[:1].copy_(cur)
        st.cur.copy_(cur.reshape(1, 1))
        st.pos.fill_(Tp)
        st.count.fill_(1)
        has_eos = eos_token_id is not None
        st.eos.fill_(eos_token_id if has_eos else -1)
        st.done.copy_(st.eos == cur)
        fb = fill_bound(Tp, max_new_tokens + k + 1)
        body = functools.partial(self._device_body, st, fb, has_eos)
        count, done = 1, bool(st.done)
        try:
            while count < max_new_tokens and not done:
                self._run_step(("device", fb, has_eos, L), body)
                count, done = (int(x) for x in torch.stack(
                    [st.count[0], st.done[0].to(torch.int64)]).cpu())
            toks = st.out[:min(count, max_new_tokens)].cpu().numpy()
        finally:
            self._counters_home(st)
        if has_eos:
            hits = np.flatnonzero(toks == eos_token_id)
            if hits.size:
                toks = toks[:hits[0] + 1]
        return toks[None, :].astype(np.int32)

    # -- the host loop -------------------------------------------------------

    def generate_stream(self, tokens, max_new_tokens: int,
                        eos_token_id: Optional[int] = None, *,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0,
                        generator: Optional[torch.Generator] = None):
        """Streaming twin of generate(): yields 1-D np.int32 blocks, the
        first token alone (time to first token), then each iteration's
        accepted and corrected tokens.  The blocks concatenate to
        generate()'s output (the same loop, the same draws)."""
        yield from self._run(tokens, max_new_tokens, eos_token_id,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p, generator=generator)

    def generate(self, tokens, max_new_tokens: int,
                 eos_token_id: Optional[int] = None, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Speculative generation.  tokens (1, T) or (T,); returns (1, n)
        np.int32, n <= max_new_tokens (early exit at EOS).

        temperature == 0: greedy, the target's greedy stream for any
        draft.  temperature > 0: Leviathan accept-reject over the HF
        warper chain (top_k, top_p), whose output distribution is the
        target's; the draws come from `generator` (a fresh one seeded 0
        when None) and a numpy generator seeded from it.  Records the
        per-iteration accepted count and clamped depth in
        last_acceptance and last_keff."""
        blocks = list(self._run(tokens, max_new_tokens, eos_token_id,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p, generator=generator))
        return np.concatenate(blocks)[None, :].astype(np.int32)

    def _run(self, tokens, max_new_tokens, eos_token_id, *, temperature,
             top_k, top_p, generator):
        """The speculative loop as a generator (kivi_tpu/serving/
        speculative.py:478-562): yields 1-D np.int32 blocks, trimmed to
        max_new_tokens and cut after the first EOS."""
        tgt, drf, k = self.target, self.draft, self.k
        sampled = temperature > 0
        warp = (dict(temperature=temperature, top_k=top_k, top_p=top_p)
                if sampled else None)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        host_rng = np.random.default_rng(int(torch.randint(
            0, 2 ** 31 - 1, (1,), generator=generator,
            device=generator.device)))
        t_logits, Tp, st = self._prefill_both(tokens, max_new_tokens)
        cur = int(sampling.sample_step(t_logits, generator,
                                       temperature=temperature, top_k=top_k,
                                       top_p=top_p)[0])
        count, last = 1, cur
        yield np.asarray([cur], np.int32)       # time to first token
        N = Tp                       # committed tokens in BOTH caches
        t_wm = self._wm_init(tgt.qcfg, Tp)
        d_wm = self._wm_init(drf.qcfg, Tp)
        fb = fill_bound(Tp, max_new_tokens + k + 1)
        gens = (generator,) if sampled else ()
        wkey = (temperature, top_k, top_p, generator if sampled else None)
        draft = functools.partial(self._draft_steps, st, k, fb, warp,
                                  generator)
        verify = functools.partial(self._verify, st, warp)
        bonus = functools.partial(self._bonus, st, fb)
        rollback = functools.partial(self._rollback, st)
        self.last_acceptance, self.last_keff = [], []
        try:
            while count < max_new_tokens and (eos_token_id is None
                                              or last != eos_token_id):
                # 0) eager boundary flushes + block clamp; cap == 0 is
                # unreachable (capacity check), the lower clamp keeps a
                # violated assumption from committing past capacity
                cap_t = self._sync_boundary(tgt, self._t_caches, t_wm, N)
                cap_d = self._sync_boundary(drf, self._d_caches, d_wm, N)
                keff = max(0, min(k, cap_t - 1, cap_d - 1))
                self.last_keff.append(keff)
                if keff < k:
                    self.stats["clamped"] += 1
                st.cur.fill_(cur)
                st.pos.fill_(N)
                # 1) k draft proposals (always k: one graph; proposals
                # past keff are not used), 2) one verify over them
                self._run_step(("draft", k, fb, wkey), draft, gens)
                self._run_step(("verify", wkey), verify)
                # 3) the accepted prefix + corrected / bonus token
                if sampled:
                    d_toks, q, p = (st.d_toks[0, :k].cpu().numpy(),
                                    st.q[0, :k].cpu().double().numpy(),
                                    st.p[0].cpu().double().numpy())
                    emitted = spec_accept(p[:keff + 1], q[:keff],
                                          d_toks[:keff],
                                          host_rng.random(keff), host_rng)
                    j = len(emitted) - 1
                else:
                    both = torch.cat([st.d_toks[0, :k],
                                      st.t_pred[0]]).cpu().numpy()
                    d_toks, t_pred = both[:k], both[k:]     # one read
                    mism = t_pred[:keff] != d_toks[:keff]
                    j = int(np.argmax(mism)) if mism.any() else keff
                    emitted = [int(t) for t in d_toks[:j]] + [int(t_pred[j])]
                self.last_acceptance.append(j)
                # 4) commit: the capped appends hold every accepted token;
                # a full accept at depth k also needs its last proposal
                # fed to the draft
                if j == k:
                    self._run_step(("bonus", fb), bonus)
                N += j + 1
                st.n.fill_(N)
                self._run_step(("rollback",), rollback)
                cur = emitted[-1]
                block = emitted[:max_new_tokens - count]
                if eos_token_id is not None and eos_token_id in block:
                    block = block[:block.index(eos_token_id) + 1]
                count += len(block)
                last = block[-1] if block else last
                if block:
                    yield np.asarray(block, np.int32)
                if eos_token_id is not None and eos_token_id in block:
                    return
        finally:
            self._counters_home(st)
