"""Failure detection and elastic recovery for the serving loop: port of
`kivi_tpu/parallel/elastic.py`.

A lost process does NOT produce an error on the survivors: their next
collective hangs (or, over gloo, may fail once the socket closes).
Detection therefore cannot ride the compute path; it needs an
out-of-band channel plus a deadline on the compute path itself:

  * `Heartbeat` — out-of-band UDP heartbeats between the serving
    processes (coordinator = process 0).  The coordinator tracks
    last-seen times and reports `dead()` processes; workers track the
    coordinator's acks and report `healthy()`.  Pure stdlib
    sockets/threads.
  * `StepWatchdog` — a deadline on a device step.  A hung collective
    never raises, so the host wraps each `step()` in a watchdog that
    flags the stall and lets the serving loop switch to recovery.
  * `surviving_mesh` / `ElasticBatcher` — recovery.  Inference state is
    cheap to rebuild (weights reload, KV caches re-prefill): form a new
    mesh over the survivors, re-shard the params, and resume every
    unfinished request by replaying prompt + already-emitted tokens as a
    longer prompt (exact continuation under greedy decoding as far as
    the prefill and the decode round alike — the emitted stream the
    client saw stays a prefix of the final result).

Multi-process caveat, as in the JAX package: a live process group
cannot drop processes.  After a loss the survivors must tear down and
re-run `multihost.initialize()` with the new process set before calling
`surviving_mesh`.  A survivor stuck in a collective cannot unwind its
stack, so the clean teardown is a process-image restart: persist the
resume state out-of-band (`write_resume_state`, kept current BEFORE each
step so a hung step never blocks it) and `exec_restart()` the survivor,
whose fresh process joins the new world
(tests/test_torch_elastic.py::test_sigkill_peer_exec_resume).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from kivi_tpu_torch.parallel.mesh import auto_mesh_shape

_MAGIC = 0x4B495649  # "KIVI"
_BEAT = struct.Struct("!IiB")  # magic, process_id, kind (0=beat, 1=ack)


class Heartbeat:
    """Out-of-band liveness: UDP beats worker -> coordinator, acks back.

    One instance per process.  `process_id == 0` is the coordinator: it
    binds `address` and answers every beat with an ack.  Workers send a
    beat every `interval` seconds.  Liveness windows are `timeout`
    seconds of silence.
    """

    def __init__(self, address: str, num_processes: int, process_id: int,
                 interval: float = 0.5, timeout: float = 3.0):
        host, port = address.rsplit(":", 1)
        self.addr = (host, int(port))
        self.n, self.pid = num_processes, process_id
        self.interval, self.timeout = interval, timeout
        self._last_seen: Dict[int, float] = {}
        self._last_ack = time.monotonic()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.settimeout(0.2)
        if self.pid == 0:
            self._sock.bind(self.addr)
        self._threads: List[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Heartbeat":
        rx = threading.Thread(target=self._rx_loop, daemon=True)
        self._threads.append(rx)
        rx.start()
        if self.pid != 0:
            tx = threading.Thread(target=self._tx_loop, daemon=True)
            self._threads.append(tx)
            tx.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._sock.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- wire loops ---------------------------------------------------------

    def _tx_loop(self):
        msg = _BEAT.pack(_MAGIC, self.pid, 0)
        while not self._stop.is_set():
            try:
                self._sock.sendto(msg, self.addr)
            except OSError:
                pass
            self._stop.wait(self.interval)

    def _rx_loop(self):
        while not self._stop.is_set():
            try:
                data, src = self._sock.recvfrom(64)
            except (socket.timeout, OSError):
                continue
            if len(data) != _BEAT.size:
                continue
            magic, pid, kind = _BEAT.unpack(data)
            if magic != _MAGIC:
                continue
            now = time.monotonic()
            if self.pid == 0 and kind == 0:
                with self._lock:
                    self._last_seen[pid] = now
                try:
                    self._sock.sendto(_BEAT.pack(_MAGIC, 0, 1), src)
                except OSError:
                    pass
            elif self.pid != 0 and kind == 1:
                self._last_ack = now

    # -- queries ------------------------------------------------------------

    def dead(self) -> set:
        """Coordinator view: workers silent past the timeout.  Workers
        never seen at all count as dead only after one full timeout from
        start (grace period for slow bring-up)."""
        assert self.pid == 0, "dead() is a coordinator-side query"
        now = time.monotonic()
        with self._lock:
            out = set()
            for p in range(1, self.n):
                seen = self._last_seen.get(p)
                if seen is None:
                    seen = getattr(self, "_t0", None)
                    if seen is None:
                        self._t0 = seen = now
                if now - seen > self.timeout:
                    out.add(p)
            return out

    def healthy(self) -> bool:
        """Worker view: coordinator acked within the timeout."""
        if self.pid == 0:
            return True
        return time.monotonic() - self._last_ack <= self.timeout


class StepWatchdog:
    """Deadline on a device step: `with StepWatchdog(5.0) as wd: step()`.

    If the body runs past `deadline` seconds, `wd.stalled` flips true
    and `on_stall` (if given) fires from a timer thread — the body
    itself cannot be interrupted (a hung collective does not
    respond to Python signals), so the callback's job is to mark the
    job degraded / alert the elastic layer, not to unwind the stack.
    """

    def __init__(self, deadline: float,
                 on_stall: Optional[Callable[[], None]] = None):
        self.deadline, self.on_stall = deadline, on_stall
        self.stalled = False

    def _fire(self):
        self.stalled = True
        if self.on_stall is not None:
            self.on_stall()

    def __enter__(self):
        self._timer = threading.Timer(self.deadline, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()


def write_resume_state(path: str, state: dict) -> None:
    """Persist host-side resume state (emitted tokens, prompts, config
    seeds — plain JSON) atomically.  Called BEFORE each device step: a
    step that hangs on a lost peer can then never block checkpointing,
    and the state on disk is exactly what the restarted process must
    replay."""
    import json
    import os
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def read_resume_state(path: str) -> Optional[dict]:
    import json
    import os
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def exec_restart(argv: Optional[List[str]] = None) -> None:
    """Replace this process image with a fresh interpreter run of
    `argv` (default: sys.argv).  This is the survivor's teardown after
    a peer loss: the hung runtime (stuck collective, wedged threads)
    is discarded wholesale, and the fresh process runs
    `multihost.initialize` with the surviving process set.  Safe to call
    from a monitor thread — the exec replaces every thread in the
    image."""
    import sys
    args = list(sys.argv if argv is None else argv)
    sys.stdout.flush()
    sys.stderr.flush()
    import os
    os.execv(sys.executable, [sys.executable] + args)




def surviving_mesh(ranks: Sequence[int], num_kv_heads: int,
                   n_model: Optional[int] = None, device=None):
    """A fresh (data, model) DeviceMesh over an explicit list of ranks of
    the current world (the survivors, after they re-ran
    `multihost.initialize` with the new process set; every rank of the
    world calls it), with `mesh.make_mesh`'s axis recipe: `model`
    bounded by the KV head count so the cache's head split stays
    legal."""
    from torch.distributed.device_mesh import DeviceMesh

    from kivi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from kivi_tpu_torch.utils.device import resolve_device

    n = len(ranks)
    if n_model is None:
        _, n_model = auto_mesh_shape(n, num_kv_heads)
    if n % n_model:
        raise ValueError(f"{n} ranks do not split into model axes of "
                         f"{n_model}")
    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(
        n // n_model, n_model)
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


class ElasticBatcher:
    """Continuous batching with failure recovery.

    Wraps `serving.batcher.ContinuousBatcher` and keeps the host-side
    request log (`uid -> (request, tokens emitted so far)`).  On
    `recover(mesh)` it rebuilds the batcher from scratch on the new
    mesh — params re-sharded, caches re-initialised — and resubmits
    every unfinished request with its emitted tokens replayed as prompt
    suffix, so each client stream resumes where it stopped (device KV
    state is the only thing lost, and it is reconstructable by
    definition).

    params: the whole model's params (each build keeps this rank's
    slices, `mesh.shard_params`); kw goes to ContinuousBatcher (device,
    prompt_buckets, ...)."""

    def __init__(self, cfg, qcfg, params, num_slots: int, max_seq_len: int,
                 mesh=None, **kw):
        self.cfg, self.qcfg, self.params = cfg, qcfg, params
        self.num_slots, self.T, self.kw = num_slots, max_seq_len, kw
        self._orig: Dict[int, object] = {}   # uid -> original Request
        self._emitted: Dict[int, List[int]] = {}
        self._prefix: Dict[int, List[int]] = {}
        self.batcher = None
        self._build(mesh)

    def _build(self, mesh):
        from kivi_tpu_torch.parallel.mesh import mesh_coords, shard_params
        from kivi_tpu_torch.serving.batcher import ContinuousBatcher

        self.mesh = mesh
        _, _, n_model, model_rank = mesh_coords(mesh)
        params = shard_params(self.params, self.cfg, n_model, model_rank)
        # every uid in the old results is by definition finished (or
        # rejected), so ALL of them carry over; unfinished requests are
        # resubmitted by the recovery path.  The old batcher's caches go
        # before the new ones are allocated.
        results = {} if self.batcher is None else self.batcher.results
        self.batcher = None
        self.batcher = ContinuousBatcher(
            self.cfg, self.qcfg, params, num_slots=self.num_slots,
            max_seq_len=self.T, mesh=mesh, **self.kw)
        self.batcher.results.update(results)

    def _unfinished(self, batcher) -> set:
        return {u for u in self._orig if u not in batcher.results}

    # -- serving surface ----------------------------------------------------

    def submit(self, req) -> None:
        self._orig[req.uid] = req
        self._emitted.setdefault(req.uid, [])
        self.batcher.submit(req)

    def step(self) -> None:
        self.batcher.step()
        self._harvest()

    def _harvest(self):
        b = self.batcher
        for s in range(b.S):
            req = b.slot_req[s]
            if req is not None and req.uid in self._emitted:
                self._emitted[req.uid] = (
                    self._prefix.get(req.uid, []) + list(b.slot_out[s]))
        for uid, res in b.results.items():
            if uid in self._emitted and res.tokens:
                self._emitted[uid] = (
                    self._prefix.get(uid, []) + list(res.tokens))

    # -- recovery -----------------------------------------------------------

    def recover(self, mesh) -> List[int]:
        """Rebuild on `mesh` and resume unfinished requests.  Returns the
        resumed uids.  (Multi-process: the survivors re-run
        `multihost.initialize` with the new process set first.)"""
        from kivi_tpu_torch.serving.batcher import Request, Result

        unfinished = sorted(self._unfinished(self.batcher))
        for uid in unfinished:
            self._prefix[uid] = list(self._emitted.get(uid, []))
        self._build(mesh)
        for uid in unfinished:
            orig = self._orig[uid]
            emitted = self._prefix[uid]
            if len(emitted) >= orig.max_new_tokens:
                # everything was emitted before the failure; just record
                self.batcher.results[uid] = Result(uid, [])
                continue
            self.batcher.submit(Request(
                uid=uid,
                prompt=list(orig.prompt) + emitted,
                max_new_tokens=orig.max_new_tokens - len(emitted),
                eos_token_id=orig.eos_token_id,
                temperature=orig.temperature, top_k=orig.top_k,
                top_p=orig.top_p,
                repetition_penalty=orig.repetition_penalty))
        return unfinished

    def run(self, requests) -> Dict[int, List[int]]:
        """Drive to completion (no failures): full emitted streams."""
        for r in requests:
            self.submit(r)
        while self.batcher.queue or self.batcher.active.any():
            self.step()
        self.batcher._retire()
        self._harvest()
        return self.results()

    def results(self) -> Dict[int, List[int]]:
        """uid -> full emitted token stream (across recoveries)."""
        out = {}
        for uid in self._orig:
            if uid in self.batcher.results:
                out[uid] = (self._prefix.get(uid, [])
                            + list(self.batcher.results[uid].tokens))
            elif uid in self._emitted:
                out[uid] = list(self._emitted[uid])
        return out

    @property
    def done(self) -> bool:
        return not (self.batcher.queue or self.batcher.active.any()
                    or self._unfinished(self.batcher))
