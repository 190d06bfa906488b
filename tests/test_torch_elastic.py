"""Failure detection and elastic recovery of the port
(kivi_tpu_torch.parallel.elastic), mirroring tests/test_elastic.py and
tests/test_elastic_kill.py.

  * `Heartbeat` and `StepWatchdog`: the JAX package's cases
    (tests/test_elastic.py:48-128) on the port's copy;
  * `surviving_mesh` shapes, and an ElasticBatcher over a (2, 2) mesh of
    4 gloo processes (tensor parallel over "model") recovered onto a
    (2, 1) mesh of the first two: every request's stream equal to the
    uninterrupted port batcher's;
  * recovery in one process (f32 weights and caches, greedy): over the
    fp16 cache the resumed streams token-equal to an uninterrupted run
    of the port's batcher, each pre-failure stream a prefix of its final
    one, and, over fp16 and KIVI-2, the same streams as the JAX
    ElasticBatcher recovering at the same step over the same requests
    (its slot caches cast to f32 as tests/test_torch_batcher.py does);
  * the KIVI-2 smoke (tests/test_elastic.py:217): the pre-failure stream
    is a prefix of the final one and every request completes;
  * a REAL process death: two gloo processes serve with the model axis
    across both (every decode step's all-reduce crosses the process
    boundary), the parent SIGKILLs one mid-decode, the survivor's
    heartbeat names the dead peer, its monitor `exec_restart`s it into a
    one-process world that replays prompt + emitted tokens, and the
    spliced stream equals the no-failure run token for token.
"""

import json
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.parallel.elastic import ElasticBatcher as JElasticBatcher
from kivi_tpu.serving.batcher import Request as JRequest
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.parallel.elastic import (ElasticBatcher, Heartbeat,
                                             StepWatchdog)
from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
from torch_dist import child_env, flat_params, spawn

torch.set_num_threads(2)

CFG = tiny_config()
MAX = 256
BUCKETS = (32, 64)


def _free_port(kind=socket.SOCK_DGRAM):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _q(bits):
    return dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=32,
                scale_dtype="float32")


def _params():
    jp = JM.init_params(j_tiny_config(), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                               torch.float32)


def _requests(seed, lens, new):
    rng = np.random.RandomState(seed)
    return [dict(uid=i, prompt=[int(t) for t in
                                rng.randint(1, CFG.vocab_size, size=n)],
                 max_new_tokens=new) for i, n in enumerate(lens)]


def _port_kw():
    return dict(device="cpu", prompt_buckets=BUCKETS,
                cache_dtype=torch.float32)


def _uninterrupted(tp, bits, specs):
    bat = ContinuousBatcher(CFG, QuantConfig(**_q(bits)), tp, num_slots=2,
                            max_seq_len=MAX, **_port_kw())
    res = bat.run([Request(**s) for s in specs])
    return {u: r.tokens for u, r in res.items()}


# ---------------------------------------------------------------------------
# Heartbeat
# ---------------------------------------------------------------------------

def _wait(cond, timeout=3.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)


def test_heartbeat_detects_dead_worker():
    addr = f"127.0.0.1:{_free_port()}"
    coord = Heartbeat(addr, num_processes=3, process_id=0,
                      interval=0.05, timeout=0.5).start()
    w1 = Heartbeat(addr, num_processes=3, process_id=1,
                   interval=0.05, timeout=0.5).start()
    w2 = Heartbeat(addr, num_processes=3, process_id=2,
                   interval=0.05, timeout=0.5).start()
    try:
        _wait(lambda: not coord.dead())
        assert coord.dead() == set()          # both workers beating
        assert w1.healthy() and w2.healthy()  # acks flowing back
        w2.stop()                             # "process 2 dies"
        _wait(lambda: coord.dead() == {2})
        assert coord.dead() == {2}
        assert w1.healthy()
    finally:
        coord.stop()
        w1.stop()


def test_heartbeat_worker_detects_coordinator_loss():
    addr = f"127.0.0.1:{_free_port()}"
    coord = Heartbeat(addr, num_processes=2, process_id=0,
                      interval=0.05, timeout=0.4).start()
    w = Heartbeat(addr, num_processes=2, process_id=1,
                  interval=0.05, timeout=0.4).start()
    try:
        _wait(w.healthy)
        assert w.healthy()
        coord.stop()
        _wait(lambda: not w.healthy())
        assert not w.healthy()
    finally:
        w.stop()


def test_heartbeat_never_seen_worker_counts_dead():
    addr = f"127.0.0.1:{_free_port()}"
    coord = Heartbeat(addr, num_processes=2, process_id=0,
                      interval=0.05, timeout=0.3).start()
    try:
        # worker 1 never starts; after the grace window it must be dead
        _wait(lambda: coord.dead() == {1})
        assert coord.dead() == {1}
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# StepWatchdog
# ---------------------------------------------------------------------------

def test_watchdog_flags_stuck_step():
    fired = []
    with StepWatchdog(0.1, on_stall=lambda: fired.append(1)) as wd:
        time.sleep(0.4)
    assert wd.stalled and fired == [1]


def test_watchdog_quiet_on_fast_step():
    with StepWatchdog(5.0) as wd:
        pass
    time.sleep(0.05)
    assert not wd.stalled


# ---------------------------------------------------------------------------
# surviving_mesh and recovery across a mesh (4 gloo processes)
# ---------------------------------------------------------------------------

def test_surviving_mesh_and_recovery_on_mesh(tmp_path):
    jp, tp = _params()
    specs = _requests(2, (24, 24), 6)
    want = _uninterrupted(tp, 16, specs)
    outs = spawn("elastic", 4, tmp_path, {
        "prompts": np.array([s["prompt"] for s in specs]),
        "new": np.array(6),
        **flat_params(jax.tree_util.tree_map(np.asarray, jp))})
    for r, o in enumerate(outs):
        # 4 survivors of 4 KV heads: model takes all 4; or (2, 2) asked
        assert tuple(o["m4"]) == (1, 4) and tuple(o["m22"]) == (2, 2)
        assert tuple(o["mesh0"]) == (2, 2) and tuple(o["mesh1"]) == (2, 1)
        if r < 2:
            assert o["streams"].tolist() == [want[i] for i in range(2)]


# ---------------------------------------------------------------------------
# recovery in one process
# ---------------------------------------------------------------------------

def _elastic_run(eb, specs, fail_after, make_req):
    for s in specs:
        eb.submit(make_req(**s))
    for _ in range(fail_after):          # some requests mid-flight
        eb.step()
    before = {u: list(t) for u, t in eb._emitted.items() if t}
    resumed = eb.recover(None)           # device state lost; rebuild
    return before, resumed


def _jax_elastic(jp, bits, specs, fail_after):
    """The JAX ElasticBatcher over the same requests, failing after
    `fail_after` steps, its slot caches at f32 as the port's."""
    def f32(jeb):
        jeb.batcher.caches = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16
            else a, jeb.batcher.caches)

    with jax.default_matmul_precision("highest"):
        jeb = JElasticBatcher(j_tiny_config(), JQuantConfig(**_q(bits)), jp,
                              num_slots=2, max_seq_len=MAX,
                              prompt_buckets=BUCKETS)
        f32(jeb)
        for s in specs:
            jeb.submit(JRequest(**s))
        for _ in range(fail_after):
            jeb.step()
        jeb.recover(None)
        f32(jeb)
        while not jeb.done:
            jeb.step()
        return jeb.results()


def test_elastic_recovery_token_equal():
    """fp16: the resumed streams equal the uninterrupted port batcher's
    and the JAX ElasticBatcher's (recovering at the same step)."""
    jp, tp = _params()
    specs = _requests(1, (20, 30, 25), 10)
    want = _uninterrupted(tp, 16, specs)
    eb = ElasticBatcher(CFG, QuantConfig(**_q(16)), tp, num_slots=2,
                        max_seq_len=MAX, **_port_kw())
    before, resumed = _elastic_run(eb, specs, 4, Request)
    assert any(0 < len(t) < 10 for t in before.values()), \
        "test setup: expected an in-flight request"
    assert resumed
    while not eb.done:
        eb.step()
    got = eb.results()
    assert sorted(got) == sorted(want)
    for uid in want:
        assert got[uid] == want[uid], (uid, got[uid], want[uid])
        pre = before.get(uid, [])
        assert got[uid][:len(pre)] == pre
    assert got == _jax_elastic(jp, 16, specs, 4)


def test_elastic_recovery_matches_jax_elastic_batcher():
    """KIVI-2 at f32: the port's and the JAX package's ElasticBatcher
    fail at the same step, replay the same prompts and emit the same
    streams (neither equals an uninterrupted run: the replayed prompt
    moves the quantization groups)."""
    jp, tp = _params()
    specs = _requests(4, (20, 30, 25), 12)
    want = _jax_elastic(jp, 2, specs, 5)
    eb = ElasticBatcher(CFG, QuantConfig(**_q(2)), tp, num_slots=2,
                        max_seq_len=MAX, **_port_kw())
    _elastic_run(eb, specs, 5, Request)
    while not eb.done:
        eb.step()
    got = eb.results()
    assert got == want


def test_elastic_quantized_smoke():
    _, tp = _params()
    specs = _requests(3, (20,), 8)
    eb = ElasticBatcher(CFG, QuantConfig(2, 2, 32, 32), tp, num_slots=2,
                        max_seq_len=MAX, device="cpu",
                        prompt_buckets=BUCKETS)
    before, _ = _elastic_run(eb, specs, 3, Request)
    pre = before[0]
    assert pre
    while not eb.done:
        eb.step()
    got = eb.results()[0]
    assert len(got) == 8
    assert got[:len(pre)] == pre


# ---------------------------------------------------------------------------
# a REAL process death (tests/test_elastic_kill.py, over gloo)
# ---------------------------------------------------------------------------

CHILD = r"""
import json, os, sys, threading, time
import torch
torch.set_num_threads(1)
mode, pid, store, hb_port, resume_path = (sys.argv[1], int(sys.argv[2]),
                                          sys.argv[3], sys.argv[4],
                                          sys.argv[5])
from kivi_tpu_torch.config import ModelConfig, QuantConfig
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.parallel import elastic, multihost
from kivi_tpu_torch.parallel.mesh import mesh_coords, shard_params
from kivi_tpu_torch.serving.engine import Engine

# float32 end to end: the spliced stream crosses mesh widths (a 2-rank
# TP serve, a 1-rank resume)
CFG = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                  num_layers=2, num_heads=4, num_kv_heads=4, head_dim=32,
                  max_position_embeddings=256)
QCFG = QuantConfig(k_bits=2, v_bits=2, group_size=32, residual_length=32)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
MAX_NEW = 20


def build_engine(mesh):
    params = modeling.init_params(CFG, seed=0, dtype=torch.float32,
                                  device="cpu")
    _, _, nm, mr = mesh_coords(mesh)
    return Engine(CFG, QCFG, shard_params(params, CFG, nm, mr), 128, 1,
                  device="cpu", cache_dtype=torch.float32, mesh=mesh)


def decode(eng, emitted, on_token, pause=0.0):
    tokens = torch.tensor([PROMPT + emitted])
    tok, caches = eng.prefill(tokens)
    pos = torch.full((1, 1), tokens.shape[1])
    out = list(emitted)
    left = MAX_NEW - len(emitted)
    for i in range(left):
        out.append(int(tok[0, 0]))
        on_token(out)
        time.sleep(pause)
        if i < left - 1:
            logits, caches = eng.decode_step(tok, pos, caches)
            tok = logits.argmax(-1, keepdim=True)
            pos = pos + 1
    return out


if mode == "single":
    # the oracle (no resume state) or the survivor after its restart: a
    # one-process world over the surviving rank
    multihost.initialize("file://" + store, 1, 0, device="cpu")
    resume = elastic.read_resume_state(resume_path)
    mesh = elastic.surviving_mesh([0], num_kv_heads=4, device="cpu")
    out = decode(build_engine(mesh), list(resume["emitted"]) if resume
                 else [], lambda out: None)
    print("FINAL " + json.dumps(out), flush=True)
    sys.exit(0)

# -- two-process serve mode: the model axis across both processes, so
# every decode step's all-reduce is a cross-process collective
multihost.initialize("file://" + store, 2, pid, device="cpu")
hb = elastic.Heartbeat(f"127.0.0.1:{hb_port}", 2, pid, interval=0.25,
                       timeout=1.5).start()
eng = build_engine(multihost.global_mesh(num_kv_heads=4, n_model=2,
                                         device="cpu"))
last_done = [time.monotonic()]

if pid == 0:
    def monitor():
        while True:
            time.sleep(0.25)
            if hb.dead() and time.monotonic() - last_done[0] > 3.0:
                # peer dead + step wedged: the documented teardown
                print("RESTARTING", flush=True)
                elastic.exec_restart(
                    [sys.argv[0], "single", "0", store + ".resume", hb_port,
                     resume_path])
    threading.Thread(target=monitor, daemon=True).start()


def on_token(out):
    last_done[0] = time.monotonic()
    if pid == 0:
        elastic.write_resume_state(resume_path, {"emitted": out})
        print(f"EMITTED {len(out) - 1}", flush=True)


try:
    out = decode(eng, [], on_token, pause=0.2)
except RuntimeError:
    # gloo fails the collective once the peer's socket closes (where a
    # peer merely stops, it hangs): either way the monitor restarts
    threading.Event().wait()
if pid == 0:
    print("FINAL " + json.dumps(out), flush=True)
"""


class _Reader:
    """Collect a child's stdout lines; signal per-prefix events."""

    def __init__(self, proc):
        self.lines, self.events, self.proc = [], {}, proc
        threading.Thread(target=self._loop, daemon=True).start()

    def watch(self, prefix):
        self.events[prefix] = threading.Event()
        return self.events[prefix]

    def _loop(self):
        for line in self.proc.stdout:
            line = line.strip()
            self.lines.append(line)
            for prefix, ev in self.events.items():
                if line.startswith(prefix):
                    ev.set()

    def final(self):
        for line in self.lines:
            if line.startswith("FINAL "):
                return json.loads(line[len("FINAL "):])
        return None


def _spawn(script, args, errfile):
    # stderr to a file: a filled stderr PIPE would wedge the child
    return subprocess.Popen(
        [sys.executable, str(script)] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=open(errfile, "w"), text=True,
        bufsize=1, env=child_env())


def test_sigkill_peer_exec_resume(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    resume = tmp_path / "resume.json"

    # oracle: the same decode, one process, no failure
    po = _spawn(script, ["single", 0, tmp_path / "oracle_store", 0,
                         tmp_path / "no_resume.json"],
                tmp_path / "oracle.err")
    try:
        out, _ = po.communicate(timeout=120)
    finally:
        if po.poll() is None:
            po.kill()
    assert po.returncode == 0, (tmp_path / "oracle.err").read_text()[-2000:]
    oracle = [json.loads(line[len("FINAL "):]) for line in out.splitlines()
              if line.startswith("FINAL ")][0]
    assert len(oracle) == 20

    hb = _free_port()
    store = tmp_path / "store"
    p0 = _spawn(script, ["serve", 0, store, hb, resume], tmp_path / "p0.err")
    p1 = _spawn(script, ["serve", 1, store, hb, resume], tmp_path / "p1.err")
    r0 = _Reader(p0)
    mid, fin, restart = (r0.watch("EMITTED 4"), r0.watch("FINAL "),
                         r0.watch("RESTARTING"))
    try:
        assert mid.wait(timeout=120), (
            "serve never reached step 4: " + "\n".join(r0.lines)
            + (tmp_path / "p0.err").read_text()[-2000:])
        p1.kill()          # SIGKILL mid-decode
        p1.wait(timeout=30)
        assert restart.wait(timeout=60), (
            "survivor never detected the death: " + "\n".join(r0.lines))
        assert fin.wait(timeout=120), (
            "resumed process never finished: " + "\n".join(r0.lines)
            + (tmp_path / "p0.err").read_text()[-2000:])
        p0.wait(timeout=30)
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
                p.wait()

    got = r0.final()
    assert got == oracle, (got, oracle)
    # the resume state shows a genuine partial prefix was replayed
    st = json.loads(resume.read_text())
    assert 0 < len(st["emitted"]) < 20
    assert st["emitted"] == oracle[:len(st["emitted"])]
