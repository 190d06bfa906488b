"""Generation engine over the KIVI cache or the fp16 cache (the
baseline): port of `kivi_tpu/serving/engine.py` — one-shot prefill
(`prefill`), chunked prefill through the extend path
(`prefill_chunked`) or sequence-parallel prefill (`prefill_seqpar`,
ring attention over a mesh axis), then decode; shared prompt prefixes
(`PrefixSnapshot`, `prefill_prefix`, `extend`, the snapshot on disk)
with ragged suffixes (`generate(prefix=, suffix_lens=)`); streaming
(`generate_stream`) and beam search (`generate_beam`).

`Engine(mesh=)` runs tensor and data parallel over a (data, model)
DeviceMesh (parallel/mesh.py): its params are this rank's slice
(`shard_params`), it holds the local config (heads and MLP width over
"model") and this data rank's rows of the batch, and every forward
calls the model group's collectives (a group of size 1 issues none).
Every method takes and returns this rank's rows (`shard_tokens`,
`multihost.feed_batch`).  The ranks of a model group see the same
logits (the vocab-split logits are gathered), so with identically
seeded generators they sample the same tokens; each data rank's rows
sample with its own generator.

Decode is the port of the JAX engine's compiled `_decode_scan_fn`
(kivi_tpu/serving/engine.py:312-398).  As there, a KIVI cache's window
flushes run unconditionally at the steps the flush schedule fixes for
the known prompt length, between plain steps that do no flush checks;
the fp cache has no flushes.  A plain step (forward, repetition
penalty, sampling, teacher forcing of ragged suffixes, and the in-place
update of the token, the position and the penalty mask) runs over the
caches' counters moved to the device, (B,) int32 per counter
(`counters_to_device`; the JAX scan's traced counters), with the decode
kernels' grids cut at a static fill bound, prompt_len + steps rounded
up to 512 (`_decode_scan`, :195-220).  On CUDA the step is captured once
as a CUDA graph per static key (utils/graphs.py: batch, fill bound,
sampling controls, teacher forcing) and replayed `steps` times; the
flushes run eagerly between replays (the masked flushes with no
predicate: every row's window is full at a scheduled step).  On the CPU
the same step runs eagerly.  The tokens land in a preallocated device
buffer, and the counters return to host ints with one read at the end.
A beam step (`_beam_scan_fn`, :399-503: forward, the beams' advance and
the caches' reorder by parent, all in place) is captured the same way.

Every prompt prologue writes into the engine's own caches (`own_caches`):
a prefix snapshot is fanned out into them, never into fresh tensors, so
the graphs captured over them are replayed by every later call.

Behind a fanned-out prefix every row holds the snapshot's quantized
positions bit-equal, and the stores only grow by appending.  So the
prologue of `generate(prefix=)` and `generate_stream(prefix=)` records
`shared`, the snapshot's quantized positions rounded to whole key groups
and chunks (`decode_prefix.shared_positions`), when the batch has more
than one row, and the decode passes it down as a static argument (in the
graph key): attention reads those positions once for all rows, from row
0 of the own caches, and each row's own positions above them
(kernels/decode_prefix.py).  Every other prologue records 0, as do the
fp cache and an engine over a mesh; beam search, the batchers and the
speculative decoders never pass it.

`Engine(debug=True)` is the port of the JAX engine's checked_jit mode
(utils/guards.py): it runs the same program, with nothing captured.
Every prefill, extend and suffix forward, every scheduled flush (the
stream's segment-boundary flush included), every decode step (the same
body over the same device counters and fill bound, teacher-forced or
not) and every beam step is a checked call, run eagerly, that raises on
the first non-finite logit or appended K/V value, on a violated fill
bound, or on a flush schedule that does not match the caches.  The
split decode route (rows 7-8 of the kernel table) serves host-int
callers, `decode_step`, only.

With the tracer on (utils/profiling.py): `engine.prefill_prefix`
(`tokens`), `engine.generate` (`B`, `T`, `new`) holding
`engine.ingest` (the prompt prologue; `prefix`, its length) and
`engine.decode` (`steps`, `fb`, `flushes` run, `shared`: the positions
read once a layer, 0 off the shared-prefix route), whose last part is
`engine.decode.read`, the counters' read.  The prefix prefill, the
prologue and the decode are timed on the device too; no span sits
inside a captured step.  Over an `ExaoneMoEConfig` those three spans
also carry `ring_layers` (the layers on rings) and, from the expert
log (`self.experts`, kernels/moe_grouped.ExpertLog: the tokens on each
held expert at every expert-layer call, logged on the device inside the
steps), `routed` (the (token, expert) pairs routed to the held experts),
`expert_max` (the most on one held expert in one call) and
`experts_idle` (held experts without a token, summed over the calls):
device scalars that the tracer reads when it drains, so that no span
adds a host read.

An `ExaoneMoEConfig` (sliding layers on bf16 rings, full layers on the
KIVI or fp cache, sparse experts; models/modeling.py) runs through the
same prefill, extend, fan-out, flush schedule and replayed decode: the
rings have no flush, fan out by copying their slots, and their counters
move with the others' (`cache/ring_cache.py`); `shared` is read from
the KIVI layers.  Left pads, beam search, snapshots on disk and a mesh
raise NotImplementedError over its rings.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from kivi_tpu_torch.cache import fp_cache as FC
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache import ring_cache as RC
from kivi_tpu_torch.cache.kivi_cache import nvq_canonical
from kivi_tpu_torch.config import ExaoneMoEConfig, ModelConfig, QuantConfig
from kivi_tpu_torch.kernels.decode_prefix import shared_positions
from kivi_tpu_torch.kernels.moe_grouped import ExpertLog
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.parallel import mesh as M
from kivi_tpu_torch.parallel.ring import seq_layout
from kivi_tpu_torch.serving import sampling
from kivi_tpu_torch.utils.graphs import StepGraphs
from kivi_tpu_torch.utils.guards import checked_call
from kivi_tpu_torch.utils.profiling import TRACER, span

FILL_BUCKET = 512   # the decode fill bound's rounding (one graph per bucket)
NEG = -1e9          # a finished beam's log-probability of any token but EOS


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


# ---------------------------------------------------------------------------
# prefix snapshots (kivi_tpu/serving/engine.py:64-130)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrefixSnapshot:
    """A prefilled shared prompt prefix: batch-1 per-layer caches with
    host-int counters, and the prefix's token ids (1, T0) int64, kept
    for the repetition-penalty mask.  Made by `Engine.prefill_prefix`
    and `Engine.extend`; generate(prefix=), generate_stream,
    generate_beam and the batcher's prefix admission copy it and never
    write it.  The KIVI stores make it 4-8x smaller than an fp16
    prefix (serving/prefix_cache.snapshot_bytes)."""

    caches: list
    tokens: torch.Tensor

    @property
    def length(self) -> int:
        return self.tokens.shape[1]


def save_prefix_snapshot(path: str, snap: PrefixSnapshot) -> None:
    """Write a snapshot in the port's own format: <path>/meta.json (the
    cache kind, layer count, field names and each layer's host-int
    counters) and <path>/tensors.pt, `torch.save` of the token ids and
    each layer's tensors on the CPU.  The JAX package writes an orbax
    tree instead (ROADMAP Queue 3).  A snapshot with ring layers is not
    written (one cache kind a snapshot)."""
    if any(isinstance(c, RC.RingLayerCache) for c in snap.caches):
        raise NotImplementedError("saving a snapshot of the sliding-ring "
                                  "layers of an ExaoneMoEConfig")
    layers, counters = [], []
    for c in snap.caches:
        t, n = {}, {}
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                t[f.name] = x.detach().cpu()
            else:
                n[f.name] = int(x)
        layers.append(t)
        counters.append(n)
    os.makedirs(path, exist_ok=True)
    kind = "kivi" if isinstance(snap.caches[0], KC.KiviLayerCache) else "fp"
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"kind": kind, "num_layers": len(layers),
                   "fields": sorted(layers[0]), "counters": counters}, f)
    torch.save({"tokens": snap.tokens.detach().cpu(), "layers": layers},
               os.path.join(path, "tensors.pt"))


def load_prefix_snapshot(path: str, device=None) -> PrefixSnapshot:
    """Read a snapshot written by save_prefix_snapshot onto `device` (CUDA
    unless told otherwise), with `torch.load(weights_only=True)`.  Load
    it into an Engine of the config, cache length and cache dtype it was
    built with: a mismatch raises on first use (broadcast_rows_into)."""
    device = modeling.resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, "tensors.pt"),
                       map_location=device, weights_only=True)
    cls = KC.KiviLayerCache if meta["kind"] == "kivi" else FC.FpLayerCache
    want = sorted(f.name for f in dataclasses.fields(cls)
                  if f.name not in meta["counters"][0])
    if meta["fields"] != want:
        raise ValueError(f"{path}: fields {meta['fields']}, a {cls.__name__}"
                         f" has {want}")
    caches = [cls(**t, **n) for t, n in zip(state["layers"],
                                            meta["counters"])]
    return PrefixSnapshot(caches=caches, tokens=state["tokens"])


@dataclasses.dataclass
class _DecodeState:
    """What a captured decode step reads and writes, at fixed addresses:
    the caches (whose counters are rows of `counters` during a decode),
    the token fed and its RoPE position (B, 1) int64, the left pads (B,)
    int64, the token buffer (B, max_seq_len) int32, the step index (1,)
    int64 into it, and the last step's raw logits (B, V) f32 (before
    the penalty); the penalty mask (B, V) bool and the teacher tokens of
    ragged suffixes, forced (B, max_seq_len) int64 and n_forced (B,)
    int64, are allocated on first use.  `ptrs` identifies the caches'
    storage."""

    ptrs: tuple
    caches: list
    counters: Optional[torch.Tensor]
    token: torch.Tensor
    pos: torch.Tensor
    pad: torch.Tensor
    out: torch.Tensor
    step: torch.Tensor
    logits: torch.Tensor
    seen: Optional[torch.Tensor] = None
    forced: Optional[torch.Tensor] = None
    n_forced: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _BeamState:
    """A captured beam step's state (kivi_tpu/serving/engine.py:420-452),
    at fixed addresses: the caches and their device counters, the token
    fed and its position (N, 1) int64 with N = B * nb, the pads (N,),
    each beam's score (B, nb) f32, alive flag (B, nb) bool and length
    (B, nb) int32, its tokens (B, nb, max_seq_len) int32 kept in beam
    order, the step index (1,) int64, the log-probabilities of a
    finished beam (V,) f32 and the parent row of each beam (N,) int64,
    which the caches are reordered by."""

    ptrs: tuple
    caches: list
    counters: Optional[torch.Tensor]
    token: torch.Tensor
    pos: torch.Tensor
    pad: torch.Tensor
    scores: torch.Tensor
    alive: torch.Tensor
    lengths: torch.Tensor
    out: torch.Tensor
    step: torch.Tensor
    eos_only: torch.Tensor
    parent: torch.Tensor


@dataclasses.dataclass
class _Prompt:
    """The prompt prologue's outcome (`Engine._ingest_prompt`): the first
    fed token (B, 1), the caches holding the prompt, the next position
    (B, 1), the pads (B,) or None, the penalty mask or None, the full
    prompt length Tp (prefix included), the real rows, the raw logits of
    the prompt's last token (B, V) f32, and `ragged`: None, or (the
    first sampled candidate (B, 1), the teacher tokens (B, L), each
    row's count of them (B,), L) for ragged suffixes; `shared`, the
    leading quantized positions every row holds bit-equal (0: none
    recorded)."""

    first: torch.Tensor
    caches: list
    pos: torch.Tensor
    pad: Optional[torch.Tensor]
    seen: Optional[torch.Tensor]
    Tp: int
    n_real: int
    logits: torch.Tensor
    ragged: Optional[tuple]
    shared: int = 0


def _cache_ptrs(caches) -> tuple:
    return tuple(getattr(c, f.name).data_ptr() for c in caches
                 for f in dataclasses.fields(c)
                 if isinstance(getattr(c, f.name), torch.Tensor))


class Engine:
    """Generation engine over the KIVI cache, or over the fp16 cache when
    qcfg.quantize_kv is False (QuantConfig(16, 16, ...): the baseline).
    Runs on CUDA (the kernels; decode and beam steps replayed as CUDA
    graphs) unless built with device="cpu" (the plain versions, run
    eagerly).  debug=True: the same program run eagerly, every forward,
    flush, decode and beam step a checked call (module docstring).

    params: the port's parameter dict (modeling.init_params or
    convert.params_from_jax), already on `device`; with a mesh, this
    rank's slice of it (`parallel.mesh.shard_params`).

    mesh: a (data, model) DeviceMesh (module docstring).  cfg and
    batch_size stay the whole model's and the global batch's;
    `self.cfg` and `self.batch_size` become this rank's."""

    def __init__(self, cfg: ModelConfig, qcfg: QuantConfig, params: dict,
                 max_seq_len: int, batch_size: int, device=None,
                 cache_dtype=torch.bfloat16, debug: bool = False,
                 mesh=None):
        if mesh is not None:
            modeling.reject_rings(cfg, "Engine(mesh=) (tensor parallel)")
        hybrid = isinstance(cfg, ExaoneMoEConfig)
        n_data, _, n_model, _ = M.mesh_coords(mesh)
        self.mesh = mesh
        self.cfg, self.qcfg, self.params = (M.local_config(cfg, n_model),
                                            qcfg, params)
        M.check_local_params(params, self.cfg)
        self.max_seq_len = max_seq_len
        self.batch_size = M.local_batch(batch_size, n_data)
        self.tp = M.group_of(mesh, M.MODEL_AXIS)
        self.device = modeling.resolve_device(device)
        self.cache_dtype = cache_dtype
        self.debug = debug
        # the tokens on each held expert, per expert-layer call
        self.experts = (ExpertLog(len(cfg.experts_here), self.device)
                        if hybrid else None)
        # the counters' module: rings beside KIVI caches, KIVI, or fp
        self._cm = RC if hybrid else KC if qcfg.quantize_kv else FC
        # the model, with this rank's tensor-parallel group
        self._model = functools.partial(modeling.forward, tp=self.tp)
        if hybrid:
            self._model = functools.partial(self._model,
                                            expert_log=self.experts)
        self._forward = (checked_call(self._model) if debug
                         else self._model)
        self._flush = (checked_call(modeling.flush_caches) if debug
                       else modeling.flush_caches)
        self._caches = None   # the caches generate() prefills, reused
        self._dec: Optional[_DecodeState] = None
        self._beams: dict = {}    # (requests, beams) -> _BeamState
        self.graphs = (StepGraphs(self.device)
                       if self.device.type == "cuda" and not debug else None)

    def init_caches(self, batch: Optional[int] = None):
        return modeling.init_caches(self.cfg, self.qcfg,
                                    batch or self.batch_size,
                                    self.max_seq_len, self.cache_dtype,
                                    self.device)

    def _experts_since(self):
        """The expert log's count as a span opens (the tracer on; None
        otherwise, and for a block without experts)."""
        if self.experts is None or not TRACER.on:
            return None
        return self.experts.n.clone()

    def _experts_close(self, sp, since) -> None:
        """A span's expert counts, from the calls logged since it opened
        (module docstring): device scalars, read when the tracer drains."""
        if since is None:
            return
        sp.attrs["ring_layers"] = self.cfg.ring_layers
        t = self.experts.totals(since)
        for i, k in enumerate(("routed", "expert_max", "experts_idle")):
            sp.attrs[k] = t[i]

    def own_caches(self):
        """The engine's own caches, those every prompt prologue writes:
        allocated once and cleared on every call, so that the decode
        graphs captured over them are replayed by the next call (the JAX
        engine donates its caches instead).  A caller holding them sees
        them overwritten by the next call."""
        if self._caches is None:
            self._caches = self.init_caches()
        else:
            for c in self._caches:
                KC.clear(c)
        return self._caches

    def _fan_out(self, prefix: PrefixSnapshot):
        """The own caches, every row a copy of the snapshot's one (the
        fan-out overwrites every byte, so they are not cleared first)."""
        if self._caches is None:
            self._caches = self.init_caches()
        for c, s in zip(self._caches, prefix.caches):
            KC.broadcast_rows_into(c, s)
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

    def _extend(self, tokens: torch.Tensor, caches, prev_len: int,
                pad: Optional[torch.Tensor] = None):
        """tokens (B, T1) through the extend path onto caches holding
        prev_len tokens (a chunk of a chunked prefill, or a suffix after
        a prefix); pad (B,) is the whole prompt's left pad.  Returns
        (last-token logits (B, V) f32, caches)."""
        B, T1 = tokens.shape
        positions = (prev_len + torch.arange(T1, device=self.device)
                     ).expand(B, T1)
        if pad is not None:
            positions = torch.clamp(positions - pad[:, None], min=0)
        logits, caches = self._forward(
            self.params, tokens, caches, self.cfg, self.qcfg, positions,
            mode="extend", last_only=True, pad_len=pad, prev_len=prev_len)
        return logits[:, -1], caches

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
            logits, caches = self._extend(tokens[:, t0:t0 + chunk_size],
                                          caches, t0, pad)
        return logits, caches

    def prefill_seqpar(self, tokens, mesh, axis: str = M.DATA_AXIS,
                       caches=None, pad_lens=None, striped: bool = False):
        """One-shot prefill with the TOKEN axis split over the ranks of
        `axis` of `mesh` (kivi_tpu/serving/engine.py:508-554): attention
        runs as a ring (parallel/ring.py), so n ranks split the prompt's
        O(T^2) attention n ways.  tokens (B, T), the same on every rank,
        LEFT-padded by pad_lens (B,); T % n == 0.  Each rank embeds,
        projects and runs the MLP on its T/n block; K/V are gathered per
        layer before the cache ingest.  Returns (last-token logits (B, V)
        f32, caches), the same on every rank, the caches holding the
        whole prompt in token order (the exact-attention accuracy class
        of `prefill`, not the chunked one).

        striped: lay the tokens out in the zigzag order (needs T % 2n ==
        0) so every rank does ~equal causal work; the permutation is
        internal.  The engine's own mesh, if any, may split heads over
        "model" only: the sequence axis takes the place of "data"."""
        if axis == M.MODEL_AXIS and self.tp is not None:
            raise ValueError("the sequence axis cannot be the engine's "
                             "tensor-parallel axis")
        if self.mesh is not None and M.mesh_coords(self.mesh)[0] > 1:
            raise ValueError("prefill_seqpar on an engine whose mesh splits "
                             "the batch over 'data'")
        tokens = torch.as_tensor(tokens, device=self.device).long()
        B, T = tokens.shape
        seq = seq_layout(T, M.group_of(mesh, axis), striped, self.device)
        pad = self._pad(pad_lens, B)
        # this rank's slots hold the tokens at their true positions
        positions = seq.positions.expand(B, -1)
        if pad is not None:
            positions = torch.clamp(positions - pad[:, None], min=0)
        if caches is None:
            caches = self.init_caches(B)
        logits, caches = self._forward(
            self.params, tokens.index_select(1, seq.positions), caches,
            self.cfg, self.qcfg, positions, mode="prefill", pad_len=pad,
            seq_group=seq)
        return logits[:, -1], caches

    def prefill_prefix(self, tokens, chunk_size: Optional[int] = None,
                       seq_mesh=None) -> PrefixSnapshot:
        """Prefill a shared prompt prefix once at batch 1 and snapshot the
        caches (kivi_tpu/serving/engine.py:556-583).  tokens (T0,) or
        (1, T0).  One-shot (exact attention) unless chunk_size is given
        (prefill_chunked: chunks past the first see the quantized
        history).  seq_mesh: (mesh, axis), prefill the prefix
        sequence-parallel over that mesh axis (`prefill_seqpar`: the
        exact-attention class, unlike chunking)."""
        with span("engine.prefill_prefix", device=self.device) as sp:
            since = self._experts_since()
            tokens = torch.as_tensor(tokens, device=self.device)
            tokens = tokens.reshape(1, -1).to(torch.int64)
            sp.attrs["tokens"] = tokens.shape[1]
            caches = self.init_caches(1)
            if seq_mesh is not None:
                self.prefill_seqpar(tokens, seq_mesh[0], seq_mesh[1],
                                    caches=caches)
            elif chunk_size is None:
                self._prefill(tokens, caches)
            else:
                self.prefill_chunked(tokens, chunk_size, caches)
            self._experts_close(sp, since)
            return PrefixSnapshot(caches=caches, tokens=tokens)

    def extend(self, snapshot: PrefixSnapshot, tokens) -> PrefixSnapshot:
        """Grow a snapshot by more shared tokens (T1,) or (1, T1)
        (multi-turn prefixes; kivi_tpu/serving/engine.py:621-634): a
        copy of its caches goes through the extend path, so the stored
        snapshot is never written."""
        tokens = torch.as_tensor(tokens, device=self.device).reshape(1, -1)
        tokens = tokens.to(torch.int64)
        caches = [KC.broadcast_rows(c, 1) for c in snapshot.caches]
        self._extend(tokens, caches, snapshot.length)
        return PrefixSnapshot(
            caches=caches, tokens=torch.cat([snapshot.tokens, tokens], 1))

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

    def _events(self, prompt_len: int, steps: int) -> dict:
        return (flush_schedule(self.qcfg,
                               canonical_phase(self.qcfg, prompt_len), steps)
                if self.qcfg.quantize_kv else {})

    def decode(self, first: torch.Tensor, pos: torch.Tensor, caches, *,
               steps: int, prompt_len: int, pad_lens=None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               repetition_penalty: float = 1.0,
               seen: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               forced: Optional[torch.Tensor] = None,
               n_forced: Optional[torch.Tensor] = None, shared: int = 0):
        """Generate `steps` tokens after `first` (B, 1), whose RoPE
        position is pos (B, 1); the caches (host-int counters) hold
        prompt_len tokens.  A KIVI cache's window flushes run on the
        static schedule between steps; the fp cache has none.

        shared: the leading quantized positions every row of the KIVI
        caches holds bit-equal to row 0 (what `_ingest_prompt` records
        behind a fanned-out prefix), read once for all rows by the
        shared-prefix route; 0 (the default) keeps row 6 alone.

        forced (B, L) / n_forced (B,): teacher forcing of ragged
        suffixes (kivi_tpu/serving/engine.py:330-374): row b FEEDS
        forced[b, j + 1] after step j while j + 1 < n_forced[b], and its
        own sample after that; the emitted tokens are always the sampled
        candidates.  Teacher tokens enter the penalty mask as consumed
        prompt tokens do.

        Returns (tokens (B, steps) int32, caches), the caches updated in
        place with host-int counters again."""
        # a host int: the flush schedule and the fill bound both stand on it
        assert caches[0].seq_len == prompt_len, (
            f"the caches hold {caches[0].seq_len} tokens, not prompt_len "
            f"{prompt_len}")
        events = self._events(prompt_len, steps)
        use_pen = repetition_penalty != 1.0 and seen is not None
        fb = fill_bound(prompt_len, steps)
        with span("engine.decode", device=self.device, steps=steps, fb=fb,
                  flushes=len(events), shared=shared) as sp:
            since = self._experts_since()
            teach = forced is not None
            st = self._decode_begin(first, pos, caches, pad_lens,
                                    seen if use_pen else None, forced,
                                    n_forced)
            penalty = repetition_penalty if use_pen else 1.0
            has_pad = pad_lens is not None
            body = functools.partial(self._decode_body, st, fb, has_pad,
                                     temperature, top_k, top_p, penalty,
                                     generator, teach, shared)
            if self.debug:
                body = checked_call(body)
            # the JAX jit's static arguments but `steps` (the graph is one
            # step); the generator object itself, since a graph draws from
            # the generator it was captured with
            key = (first.shape[0], fb, has_pad, temperature, top_k, top_p,
                   penalty, generator if temperature > 0 else None, teach,
                   shared)
            gens = (generator,) if temperature > 0 and generator is not None \
                else ()
            for i in range(steps):
                if i in events:
                    fk, fv = events[i]
                    self._flush(caches, self.qcfg, k=fk, v=fv)
                if self.graphs is not None:
                    self.graphs.run(key, body, gens)
                else:
                    body()
            out = self._decode_end(st, steps)
            self._experts_close(sp, since)
            return out, caches

    def _decode_begin(self, first, pos, caches, pad_lens, seen,
                      forced=None, n_forced=None) -> _DecodeState:
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
                pos=z(B, 1), pad=z(B),
                out=z(B, self.max_seq_len, dt=torch.int32), step=z(1),
                logits=z(B, self.cfg.vocab_size, dt=torch.float32))
        st.caches = caches
        st.counters = self._cm.counters_to_device(caches, st.counters)
        st.token.copy_(first.reshape(B, 1))
        st.pos.copy_(torch.as_tensor(pos).reshape(B, 1))
        if pad_lens is not None:
            st.pad.copy_(self._pad(pad_lens, B))
        if seen is not None:
            if st.seen is None:
                st.seen = torch.zeros(seen.shape, dtype=torch.bool,
                                      device=self.device)
            st.seen.copy_(seen)
        if forced is not None:
            if st.forced is None:
                st.forced = torch.zeros((B, self.max_seq_len),
                                        dtype=torch.int64, device=self.device)
                st.n_forced = torch.zeros(B, dtype=torch.int64,
                                          device=self.device)
            st.forced[:, :forced.shape[1]].copy_(forced)
            st.n_forced.copy_(n_forced)
        st.step.zero_()
        return st

    def _decode_body(self, st: _DecodeState, fill_bound: int,
                     has_pad: bool, temperature: float, top_k: int,
                     top_p: float, penalty: float,
                     generator: Optional[torch.Generator],
                     teach: bool = False, shared: int = 0) -> None:
        """One plain decode step, the body a CUDA graph captures: reads
        and writes only the state's tensors, in place.  teach: feed the
        teacher token forced[:, step + 1] to the rows that still have one
        (the step index is the state's, on the device); shared: as in
        `decode`."""
        logits, _ = self._model(
            self.params, st.token, st.caches, self.cfg, self.qcfg, st.pos,
            mode="decode", flush=False, pad_len=st.pad if has_pad else None,
            fill_bound=fill_bound, shared=shared)
        logits = logits[:, -1]
        st.logits.copy_(logits)
        if penalty != 1.0:
            # the consumed token joins the sequence before the penalty
            st.seen.scatter_(1, st.token, True)
            logits = sampling.apply_repetition_penalty(logits, st.seen,
                                                       penalty)
        nxt = sampling.sample_step(logits, generator,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p)
        st.out.index_copy_(1, st.step, nxt[:, None])
        fed = nxt[:, None].to(torch.int64)
        if teach:
            j1 = st.step + 1
            fed = torch.where((j1 < st.n_forced)[:, None],
                              st.forced.index_select(1, j1), fed)
        st.step += 1
        st.token.copy_(fed)
        st.pos += 1

    def _decode_end(self, st: _DecodeState, steps: int) -> torch.Tensor:
        """The counters back to host ints (one read); the tokens."""
        with span("engine.decode.read"):
            self._cm.counters_to_host(st.caches, st.counters)
        return st.out[:, :steps].clone()

    def _ingest_prompt(self, tokens, max_new_tokens: int, *, pad_lens=None,
                       prefix: Optional[PrefixSnapshot] = None,
                       prefill_chunk_size: Optional[int] = None,
                       repetition_penalty: float = 1.0,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0,
                       generator: Optional[torch.Generator] = None,
                       suffix_lens=None) -> _Prompt:
        """The prompt prologue of generate() and generate_stream()
        (kivi_tpu/serving/engine.py:738-838): batch top-up, the prompt
        into the engine's own caches (one-shot, chunked, or the prefix
        fanned out and the suffix through the extend path at prev_len =
        prefix.length), the penalty mask over prefix and suffix, and the
        first token, sampled through the same chain as the rest.  With
        ragged suffix_lens the common min(suffix_lens) tokens are
        extended and each row's rest is teacher-forced by the decode;
        `first` is then the first FED token (a teacher token where a
        row has more).  Behind a prefix over the KIVI cache, with more
        than one row and no mesh, it records `shared` (module
        docstring); every other prologue records 0."""
        with span("engine.ingest", device=self.device,
                  prefix=0 if prefix is None else prefix.length) as sp:
            since = self._experts_since()
            tokens = torch.as_tensor(tokens, device=self.device)
            B, T = tokens.shape
            n_real = B
            lens = (None if suffix_lens is None
                    else [int(x) for x in suffix_lens])
            if lens is not None:
                if prefix is None:
                    raise ValueError("suffix_lens= needs prefix=")
                if len(lens) != B or not all(1 <= n <= T for n in lens):
                    raise ValueError(f"suffix_lens {lens} for {B} rows of {T}")
            if prefix is not None and (pad_lens is not None
                                       or prefill_chunk_size is not None):
                raise ValueError("prefix= composes with suffix_lens=, not "
                                 "with pad_lens= or prefill_chunk_size=")
            pad = self._pad(pad_lens, B)
            if B < self.batch_size:
                extra = self.batch_size - B
                tokens = torch.cat([tokens, tokens[-1:].expand(extra, T)])
                if pad is not None:
                    pad = torch.cat([pad, pad[-1:].expand(extra)])
                if lens is not None:
                    lens = lens + [lens[-1]] * extra
                B = self.batch_size
            assert B == self.batch_size
            if lens is not None:
                T = max(lens)                     # drop unused right padding
                tokens = tokens[:, :T]
                if min(lens) == T:
                    lens = None                   # equal lengths: normal path
            P = 0 if prefix is None else prefix.length
            Tp = P + T
            assert Tp + max_new_tokens <= self.max_seq_len, "cache too small"
            Tmin = T if lens is None else min(lens)
            if prefix is None:
                caches = self.own_caches()
                if prefill_chunk_size is None:
                    logits, caches = self._prefill(tokens, caches, pad)
                else:
                    logits, caches = self.prefill_chunked(
                        tokens, prefill_chunk_size, caches, pad)
                full = tokens
            else:
                logits, caches = self._extend(tokens[:, :Tmin],
                                              self._fan_out(prefix), P)
                suf = tokens
                if lens is not None:
                    # the padding past a row's length must not enter the
                    # penalty mask: repeat the row's last real token there
                    ln = torch.tensor(lens, device=self.device)[:, None]
                    last = tokens.gather(1, ln - 1)
                    live = torch.arange(T, device=self.device)[None] < ln
                    suf = torch.where(live, tokens, last)
                full = torch.cat([prefix.tokens.to(tokens.dtype).expand(B, P),
                                  suf], 1)
            seen = None
            lg = logits
            if repetition_penalty != 1.0:
                seen = sampling.seen_mask_from_prompt(
                    full, self.cfg.vocab_size, pad_len=pad)
                lg = sampling.apply_repetition_penalty(logits, seen,
                                                       repetition_penalty)
            first = sampling.sample_step(lg, generator,
                                         temperature=temperature,
                                         top_k=top_k, top_p=top_p)[:, None]
            ragged = None
            if lens is not None:
                n_tail = torch.tensor([n - Tmin for n in lens],
                                      dtype=torch.int64, device=self.device)
                forced = tokens[:, Tmin:].to(torch.int64)
                cand0 = first
                first = torch.where(n_tail[:, None] > 0, forced[:, :1],
                                    cand0.to(torch.int64)).to(torch.int32)
                ragged = (cand0, forced, n_tail, T - Tmin)
            # the RoPE position of the first fed token: the tokens cached
            pos = torch.full((B, 1), P + Tmin, dtype=torch.int64,
                             device=self.device)
            if pad is not None:
                pos = pos - pad[:, None]
            shared = 0
            if (prefix is not None and self.qcfg.quantize_kv and B > 1
                    and self.mesh is None):
                c = next(c for c in prefix.caches
                         if isinstance(c, KC.KiviLayerCache))
                shared = shared_positions(c.n_k_quant, c.n_v_quant,
                                          self.qcfg.group_size)
            self._experts_close(sp, since)
            return _Prompt(first=first, caches=caches, pos=pos, pad=pad,
                           seen=seen, Tp=Tp, n_real=n_real, logits=logits,
                           ragged=ragged, shared=shared)

    def generate(self, tokens: torch.Tensor, max_new_tokens: int, *,
                 prefill_chunk_size: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, repetition_penalty: float = 1.0,
                 pad_lens=None,
                 generator: Optional[torch.Generator] = None,
                 prefix: Optional[PrefixSnapshot] = None,
                 suffix_lens=None) -> torch.Tensor:
        """Greedy/sampled generation: tokens (B, T) -> (B, max_new_tokens)
        int32.  tokens may be LEFT-padded (pad_lens (B,)); a batch
        smaller than batch_size is topped up with copies of the last row
        and the extras are dropped.  Rows past their EOS emit
        eos_token_id.

        Without prefill_chunk_size the prompt is prefilled one-shot
        (exact attention over the whole prompt); with it, in chunks
        through the extend path (earlier chunks seen quantized).

        prefix: a prefill_prefix snapshot of a shared prompt prefix;
        tokens are then each request's suffix.  The snapshot is fanned
        out over the batch and only the suffix is prefilled (it attends
        the quantized prefix).  suffix_lens (B,): ragged suffixes, row
        b's being tokens[b, :suffix_lens[b]] (needs prefix=, no
        pad_lens): the common min(suffix_lens) tokens go through the
        extend path, each row's rest is teacher-forced through decode
        steps, and each row's stream is realigned after
        (kivi_tpu/serving/engine.py:686-731)."""
        B, T = np.shape(tokens)
        with span("engine.generate", B=B, T=T, new=max_new_tokens):
            pr = self._ingest_prompt(
                tokens, max_new_tokens, pad_lens=pad_lens, prefix=prefix,
                prefill_chunk_size=prefill_chunk_size,
                repetition_penalty=repetition_penalty, temperature=temperature,
                top_k=top_k, top_p=top_p, generator=generator,
                suffix_lens=suffix_lens)
            kw = dict(pad_lens=pr.pad, temperature=temperature, top_k=top_k,
                      top_p=top_p, repetition_penalty=repetition_penalty,
                      seen=pr.seen, generator=generator, shared=pr.shared)
            if pr.ragged is None:
                out = pr.first
                if max_new_tokens > 1:
                    rest, _ = self.decode(pr.first, pr.pos, pr.caches,
                                          steps=max_new_tokens - 1,
                                          prompt_len=pr.Tp, **kw)
                    out = torch.cat([pr.first, rest], dim=1)
            else:
                cand0, forced, n_tail, L = pr.ragged
                rest, _ = self.decode(pr.first, pr.pos, pr.caches,
                                      steps=L + max_new_tokens - 1,
                                      prompt_len=pr.Tp - L, forced=forced,
                                      n_forced=n_tail, **kw)
                stream = torch.cat([cand0, rest], dim=1)
                idx = n_tail[:, None] + torch.arange(max_new_tokens,
                                                     device=self.device)
                out = stream.gather(1, idx)
            out = out[:pr.n_real]
            if eos_token_id is not None:
                hit = (out == eos_token_id).to(torch.int32)
                keep = (torch.cumsum(hit, dim=1) - hit) == 0   # before eos
                out = torch.where(keep, out,
                                  torch.full_like(out, eos_token_id))
            return out

    def generate_stream(self, tokens, max_new_tokens: int, *,
                        segment: int = 16,
                        eos_token_id: Optional[int] = None,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0,
                        repetition_penalty: float = 1.0, pad_lens=None,
                        generator: Optional[torch.Generator] = None,
                        prefix: Optional[PrefixSnapshot] = None,
                        prefill_chunk_size: Optional[int] = None):
        """Streaming generation (kivi_tpu/serving/engine.py:839-933):
        yields np.int32 blocks (n_rows, <= segment) as they decode, the
        first being the first token alone (time to first token), then
        one decode of `segment` steps each.  The tokens equal
        generate()'s (the same prologue, steps and draws from one
        generator), rows past their EOS emit eos_token_id, and the
        stream ends once every row has finished."""
        pr = self._ingest_prompt(
            tokens, max_new_tokens, pad_lens=pad_lens, prefix=prefix,
            prefill_chunk_size=prefill_chunk_size,
            repetition_penalty=repetition_penalty, temperature=temperature,
            top_k=top_k, top_p=top_p, generator=generator)
        done = np.zeros(pr.n_real, bool)

        def emit(block):
            """EOS-pad finished rows: (the host block, every row done)."""
            block = block[:pr.n_real].cpu().numpy().astype(np.int32)
            if eos_token_id is None:
                return block, False
            for j in range(block.shape[1]):
                block[done, j] = eos_token_id
                done[:] |= block[:, j] == eos_token_id
            return block, bool(done.all())

        cur, pos, seen = pr.first, pr.pos, pr.seen
        blk, stop = emit(cur)
        yield blk
        emitted = 1
        while emitted < max_new_tokens and not stop:
            steps = min(segment, max_new_tokens - emitted)
            # the tokens cached at the segment's start: its input token
            # is not appended yet
            pl = pr.Tp + emitted - 1
            rest, caches = self.decode(
                cur, pos, pr.caches, steps=steps, prompt_len=pl,
                pad_lens=pr.pad, temperature=temperature, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty,
                seen=seen, generator=generator, shared=pr.shared)
            # A flush due AT the boundary is not run by the decode (it
            # flushes before appends).  The state the next segment's
            # schedule assumes is asymmetric there: prefill-canonical K
            # at T % W == 0 is already flushed, so K flushes here; the
            # canonical V keeps its full window, and the next schedule
            # flushes it at its step 0, so flushing V here too would
            # flush it twice (n_v_win < 0).
            ev = self._events(pl, steps + 1).get(steps)
            if ev is not None and ev[0]:
                self._flush(pr.caches, self.qcfg, k=True, v=False)
            if seen is not None:
                # the segment's tokens join the penalty mask (the
                # decode's own updates stay in its state)
                seen = seen.clone().scatter_(
                    1, torch.cat([cur, rest], 1).long(), True)
            cur = rest[:, -1:]
            pos = pos + steps
            emitted += steps
            blk, stop = emit(rest)
            yield blk

    # -- beam search (kivi_tpu/serving/engine.py:399-503, 934-980) ---------

    def _beam_begin(self, caches, B: int, nb: int, first_pos, pad,
                    eos: int) -> _BeamState:
        """Load the beam state of this (requests, beams) shape, one kept
        per shape so that its graphs stay valid (made anew, and every
        graph dropped, when the caches are not the ones it was made
        over)."""
        N, V, S = B * nb, self.cfg.vocab_size, self.max_seq_len
        ptrs = _cache_ptrs(caches)
        st = self._beams.get((B, nb))
        if st is None or st.ptrs != ptrs:
            if st is not None and self.graphs is not None:
                self.graphs.clear()

            def z(*shape, dt=torch.int64):
                return torch.zeros(shape, dtype=dt, device=self.device)

            st = self._beams[B, nb] = _BeamState(
                ptrs=ptrs, caches=caches, counters=None, token=z(N, 1),
                pos=z(N, 1), pad=z(N), scores=z(B, nb, dt=torch.float32),
                alive=z(B, nb, dt=torch.bool),
                lengths=z(B, nb, dt=torch.int32),
                out=z(B, nb, S, dt=torch.int32), step=z(1),
                eos_only=z(V, dt=torch.float32), parent=z(N))
        st.caches = caches
        st.scores.fill_(NEG)
        st.scores[:, 0] = 0.0           # one live beam per request at first
        st.alive.fill_(True)
        st.lengths.zero_()
        st.step.zero_()
        st.eos_only.fill_(NEG)
        st.eos_only[eos] = 0.0
        st.pos.copy_(first_pos)
        if pad is not None:
            st.pad.copy_(pad)
        return st

    @staticmethod
    def _beam_advance(st: _BeamState, logits: torch.Tensor, eos: int):
        """One beam step from logits (N, V), in place: log-softmax; a
        finished beam may emit only EOS, at no cost; top nb of (B, nb*V)
        continuations; each beam's alive flag, length and tokens taken
        from its parent; the parent rows (N,) for the caches' reorder and
        the tokens to feed."""
        B, nb = st.scores.shape
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = torch.where(st.alive.reshape(-1, 1), logp, st.eos_only)
        total = st.scores.reshape(B, nb, 1) + logp.reshape(B, nb, V)
        top, flat = torch.topk(total.reshape(B, nb * V), nb, dim=-1)
        parent = flat // V
        token = flat % V
        alive = st.alive.gather(1, parent) & (token != eos)
        st.lengths.copy_(st.lengths.gather(1, parent)
                         + alive.to(torch.int32))
        st.alive.copy_(alive)
        st.out.copy_(st.out.gather(1, parent[:, :, None].expand_as(st.out)))
        st.out.index_copy_(2, st.step, token[:, :, None].to(torch.int32))
        st.scores.copy_(top)
        st.step += 1
        st.parent.copy_((torch.arange(B, device=parent.device)[:, None] * nb
                         + parent).reshape(-1))
        st.token.copy_(token.reshape(-1, 1))

    def _beam_body(self, st: _BeamState, fb: int, has_pad: bool,
                   eos: int) -> None:
        """One beam step, the body a CUDA graph captures: the forward,
        the advance and the caches' reorder by parent (below the fill
        bound), all in place."""
        logits, _ = self._model(
            self.params, st.token, st.caches, self.cfg, self.qcfg, st.pos,
            mode="decode", flush=False, pad_len=st.pad if has_pad else None,
            fill_bound=fb)
        self._beam_advance(st, logits[:, -1], eos)
        for c in st.caches:
            KC.reorder_into(c, st.parent, fb)
        st.pos += 1

    def generate_beam(self, tokens, max_new_tokens: int, num_beams: int,
                      eos_token_id: int = -1, length_penalty: float = 1.0,
                      pad_lens=None,
                      prefix: Optional[PrefixSnapshot] = None
                      ) -> torch.Tensor:
        """Beam search: tokens (B, T) -> (B, max_new_tokens) int32, the
        best beam of each request.  The engine's batch_size must be
        B * num_beams (the beams live as batch rows; the caches are
        reordered by parent every step, below the decode's fill bound).
        eos_token_id=-1 disables EOS.  length_penalty: HF's score /
        length ** penalty.  prefix: as in generate(), every beam sharing
        the fanned-out snapshot.  tokens may be LEFT-padded (pad_lens
        (B,)) without a prefix."""
        modeling.reject_rings(self.cfg, "beam search")
        tokens = torch.as_tensor(tokens, device=self.device)
        B, T = tokens.shape
        nb = num_beams
        N = B * nb
        if N != self.batch_size:
            raise ValueError(f"engine batch_size {self.batch_size} != B * "
                             f"num_beams = {N}")
        if prefix is not None and pad_lens is not None:
            raise ValueError("prefix= and pad_lens= do not compose")
        P = 0 if prefix is None else prefix.length
        Tp = P + T
        assert Tp + max_new_tokens <= self.max_seq_len, "cache too small"
        tiled = tokens.repeat_interleave(nb, dim=0)
        pad = (None if pad_lens is None else
               self._pad(pad_lens, B).repeat_interleave(nb))
        if prefix is None:
            caches = self.own_caches()
            first_logits, caches = self._prefill(tiled, caches, pad)
        else:
            first_logits, caches = self._extend(tiled, self._fan_out(prefix),
                                                P)
        pos = torch.full((N, 1), Tp, dtype=torch.int64, device=self.device)
        if pad is not None:
            pos = pos - pad[:, None]
        eos = int(eos_token_id)
        fb = min(fill_bound(Tp, max_new_tokens), self.max_seq_len)
        st = self._beam_begin(caches, B, nb, pos, pad, eos)
        # token 0 comes from the prefill logits, outside the replays
        self._beam_advance(st, first_logits, eos)
        for c in caches:
            KC.reorder_into(c, st.parent, fb)
        n_body = max_new_tokens - 1
        events = self._events(Tp, n_body)
        cm = KC if self.qcfg.quantize_kv else FC
        st.counters = cm.counters_to_device(caches, st.counters)
        has_pad = pad is not None
        body = functools.partial(self._beam_body, st, fb, has_pad, eos)
        if self.debug:
            body = checked_call(body)
        key = ("beam", N, nb, fb, has_pad, eos)
        for i in range(n_body):
            if i in events:
                fk, fv = events[i]
                self._flush(caches, self.qcfg, k=fk, v=fv)
            if self.graphs is not None:
                self.graphs.run(key, body)
            else:
                body()
        cm.counters_to_host(caches, st.counters)
        lengths = st.lengths.clamp(min=1).to(torch.float32)
        best = (st.scores / lengths ** length_penalty).argmax(dim=1)
        return st.out[torch.arange(B, device=self.device), best,
                      :max_new_tokens].clone()
