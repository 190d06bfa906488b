"""Multi-process runs of the port's parallel tier over gloo, for the CPU
tests (tests/test_torch_mesh.py, _ring, _multihost, _elastic, _spec_tp).

`spawn(case, world, tmp_path, inputs)` runs this file as a script in
`world` processes, `python tests/torch_dist.py CASE RANK WORLD DIR`:
each joins one gloo world through a FileStore under DIR
(`multihost.initialize`), reads the parent's seeded inputs from
DIR/inputs.npz, runs CASES[CASE] and writes its results to
DIR/out{RANK}.npz.  The children import torch, numpy and
kivi_tpu_torch only (never JAX: the parent holds the JAX side), and
each runs under a timeout, so a hung collective fails the test instead
of eating the suite's clock.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def spawn(case: str, world: int, tmp_path, inputs: dict,
          timeout: float = 240.0) -> list:
    """Run CASES[case] in `world` gloo processes; returns each rank's
    results (a dict of numpy arrays), in rank order."""
    d = str(tmp_path / case)
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    procs = []
    for r in range(world):
        err = open(os.path.join(d, f"err{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r),
             str(world), d], stdout=subprocess.DEVNULL, stderr=err,
            env=child_env()), err))
    failed = []
    try:
        for r, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{case}: rank {r} timed out") from None
            if rc != 0:
                failed.append(r)
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    if failed:
        with open(os.path.join(d, f"err{failed[0]}.txt")) as f:
            raise AssertionError(f"{case}: rank {failed[0]} failed:\n"
                                 + f.read()[-3000:])
    return [dict(np.load(os.path.join(d, f"out{r}.npz")))
            for r in range(world)]


def flat_params(np_params: dict) -> dict:
    """The JAX params pytree (numpy leaves) as flat npz entries."""
    out = {k: np.asarray(np_params[k]) for k in ("embed", "ln_f", "lm_head")}
    out.update({f"layers.{k}": np.asarray(v)
                for k, v in np_params["layers"].items()})
    return out


# ---------------------------------------------------------------------------
# the child side
# ---------------------------------------------------------------------------

def _params(inp, dtype):
    from kivi_tpu_torch.models.convert import params_from_jax
    tree = {k: inp[k] for k in ("embed", "ln_f", "lm_head")}
    tree["layers"] = {k[len("layers."):]: v for k, v in inp.items()
                      if k.startswith("layers.")}
    return params_from_jax(tree, "cpu", dtype)


def _cfg(inp):
    from kivi_tpu_torch.config import tiny_config
    return tiny_config(**{k[len("cfg."):]: int(v) for k, v in inp.items()
                          if k.startswith("cfg.")})


def _qcfg(bits: int, residual: int = 64):
    from kivi_tpu_torch.config import QuantConfig
    return QuantConfig(bits, bits, 32, residual, scale_dtype="float32")


def case_mesh_engine(inp, rank, world, d):
    """Engine(mesh=) at f32 over a (data, model) mesh, teacher-forced:
    the prefill logits, STEPS decode steps' logits and a prefix extend's
    logits of this rank's rows, on KIVI-2 and fp16; and a sharded
    checkpoint restore equal to shard_params."""
    import torch

    from kivi_tpu_torch.cache import kivi_cache as KC
    from kivi_tpu_torch.models import checkpoint
    from kivi_tpu_torch.parallel import mesh as M
    from kivi_tpu_torch.parallel import multihost
    from kivi_tpu_torch.serving.engine import Engine

    cfg, p = _cfg(inp), _params(inp, torch.float32)
    mesh = multihost.global_mesh(cfg.num_kv_heads,
                                 n_model=int(inp["n_model"]), device="cpu")
    nd, dr, nm, mr = M.mesh_coords(mesh)
    lp = M.shard_params(p, cfg, nm, mr)
    out = {"coords": np.array([nd, dr, nm, mr])}
    toks = M.shard_tokens(torch.from_numpy(inp["tokens"]), nd, dr)
    steps = M.shard_tokens(torch.from_numpy(inp["steps"]), nd, dr)
    suffix = M.shard_tokens(torch.from_numpy(inp["suffix"]), nd, dr)
    B, T = toks.shape
    for bits in (2, 16):
        eng = Engine(cfg, _qcfg(bits), lp, int(inp["max_len"]),
                     int(inp["batch"]), device="cpu",
                     cache_dtype=torch.float32, mesh=mesh)
        lg, caches = eng._prefill(toks)
        out[f"prefill{bits}"] = lg.numpy()
        dec = []
        for i in range(steps.shape[1]):
            pos = torch.full((B, 1), T + i)
            lg, caches = eng.decode_step(steps[:, i:i + 1], pos, caches)
            dec.append(lg.numpy())
        out[f"decode{bits}"] = np.stack(dec)
        snap = eng.prefill_prefix(torch.from_numpy(inp["prefix"]))
        caches = [KC.broadcast_rows(c, B) for c in snap.caches]
        lg, _ = eng._extend(suffix, caches, snap.length)
        out[f"extend{bits}"] = lg.numpy()
    _, got = checkpoint.load_checkpoint(str(inp["ckpt"]), device="cpu",
                                        mesh=mesh)
    want = M.shard_params(checkpoint.load_checkpoint(
        str(inp["ckpt"]), device="cpu")[1], cfg, nm, mr)
    out["ckpt_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want))))
    return out


def _leaves(params):
    out = [params["embed"], params["ln_f"], params["lm_head"]]
    for lp in params["layers"]:
        out += [lp[k] for k in sorted(lp)]
    return out


def case_ring(inp, rank, world, d):
    """ring_attention over the world on each case's inputs: this rank's
    block of slots (in the zigzag order where the case says so)."""
    import torch
    import torch.distributed as dist

    from kivi_tpu_torch.parallel.ring import ring_attention, zigzag_perm

    group = dist.group.WORLD
    out = {}
    for name in [str(x) for x in inp["cases"]]:
        q, k, v = (torch.from_numpy(inp[f"{name}.{x}"].astype(np.float32))
                   for x in "qkv")
        if inp[f"{name}.bf16"]:
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        T = q.shape[2]
        Tl = T // world
        perm = (zigzag_perm(T, world)[0] if inp[f"{name}.zigzag"]
                else np.arange(T))
        blk = torch.from_numpy(perm[rank * Tl:(rank + 1) * Tl]).long()
        kw = {}
        if inp[f"{name}.zigzag"]:
            kw["positions"] = blk
        if int(inp[f"{name}.window"]):
            kw["sliding_window"] = int(inp[f"{name}.window"])
        if int(inp[f"{name}.chunk"]):
            kw["score_chunk"] = int(inp[f"{name}.chunk"])
        if f"{name}.pad" in inp:
            kw["pad_len"] = torch.from_numpy(inp[f"{name}.pad"])
        got = ring_attention(q.index_select(2, blk), k.index_select(2, blk),
                             v.index_select(2, blk), group, **kw)
        assert got.dtype == q.dtype
        out[name] = got.float().numpy()
        out[f"{name}.slots"] = blk.numpy()
    return out


def case_seqpar(inp, rank, world, d):
    """Engine.prefill_seqpar over the world (contiguous, striped, striped
    with left pads): the last logits, every layer's K/V codes and one
    teacher-forced decode step's logits; prefill_prefix(seq_mesh=); and
    the refusal of an indivisible length."""
    import torch

    from kivi_tpu_torch.parallel import multihost
    from kivi_tpu_torch.serving.engine import Engine

    cfg, p = _cfg(inp), _params(inp, torch.float32)
    mesh = multihost.global_mesh(cfg.num_kv_heads, n_model=1, device="cpu")
    toks = torch.from_numpy(inp["tokens"])
    B, T = toks.shape
    out = {}
    for name, striped, pads in (("contig", False, None),
                                ("striped", True, None),
                                ("padded", True, inp["pads"])):
        bits = 8 if name == "padded" else 2
        eng = Engine(cfg, _qcfg(bits, 32), p, 256, B, device="cpu",
                     cache_dtype=torch.float32)
        lg, caches = eng.prefill_seqpar(toks, mesh, pad_lens=pads,
                                        striped=striped)
        out[f"{name}.logits"] = lg.numpy()
        out[f"{name}.k_codes"] = np.stack([c.k_codes.numpy()
                                           for c in caches])
        out[f"{name}.v_codes"] = np.stack([c.v_codes.numpy()
                                           for c in caches])
        nxt = torch.from_numpy(inp[f"{name}.next"])
        pos = torch.full((B, 1), T)
        if pads is not None:
            pos = pos - torch.from_numpy(pads)[:, None]
        lg, _ = eng.decode_step(nxt, pos, caches, pad_lens=pads)
        out[f"{name}.decode"] = lg.numpy()
    eng = Engine(cfg, _qcfg(2, 32), p, 256, 1, device="cpu",
                 cache_dtype=torch.float32)
    snap = eng.prefill_prefix(toks[0], seq_mesh=(mesh, "data"))
    one = eng.prefill_prefix(toks[0])
    out["prefix_equal"] = np.array(min(
        float((a.k_codes == b.k_codes).float().mean())
        for a, b in zip(snap.caches, one.caches)))
    try:
        eng.prefill_seqpar(toks[:, :T - 1], mesh)
        out["indivisible"] = np.array("no error")
    except ValueError as e:
        out["indivisible"] = np.array(str(e))
    return out


def case_multihost(inp, rank, world, d):
    """global_mesh's shapes, and each rank feeding its own rows: the
    global sum over the data axis, which every rank must agree on."""
    import torch
    import torch.distributed as dist

    from kivi_tpu_torch.parallel import multihost

    auto = multihost.global_mesh(num_kv_heads=4, device="cpu")
    mesh = multihost.global_mesh(num_kv_heads=4, n_model=1, device="cpu")
    local = np.arange(4 * 6, dtype=np.int64).reshape(4, 6) + 1000 * rank
    batch = multihost.feed_batch(mesh, local)
    total = batch.sum().reshape(1)
    dist.all_reduce(total, group=mesh.get_group("data"))
    return {"auto": np.array(auto.mesh.shape), "mesh": np.array(
        mesh.mesh.shape), "shape": np.array(batch.shape),
        "total": total.numpy(), "device": np.array(str(batch.device)),
        "backend": np.array(dist.get_backend())}


def case_elastic(inp, rank, world, d):
    """surviving_mesh's shapes over 4 ranks, then an ElasticBatcher on
    the (data, model) mesh of all 4 (TP over "model") stepped once and
    recovered onto a (2, 1) mesh of the first two ranks (the other two
    leave; the params go back whole):
    the streams of every request (fp16 cache, f32, greedy)."""
    import torch

    from kivi_tpu_torch.parallel.elastic import (ElasticBatcher,
                                                 surviving_mesh)
    from kivi_tpu_torch.serving.batcher import Request

    cfg, p = _cfg(inp), _params(inp, torch.float32)
    H = cfg.num_kv_heads
    m4 = surviving_mesh(range(4), num_kv_heads=4, device="cpu")
    m22 = surviving_mesh(range(4), num_kv_heads=4, n_model=2, device="cpu")
    out = {"m4": np.array(m4.mesh.shape), "m22": np.array(m22.mesh.shape)}
    mesh0 = surviving_mesh(range(world), num_kv_heads=H, device="cpu")
    eb = ElasticBatcher(cfg, _qcfg(16), p, num_slots=2, max_seq_len=256,
                        mesh=mesh0, device="cpu", prompt_buckets=(32, 64),
                        cache_dtype=torch.float32)
    prompts = inp["prompts"]
    for i, row in enumerate(prompts):
        eb.submit(Request(uid=i, prompt=[int(t) for t in row],
                          max_new_tokens=int(inp["new"])))
    eb.step()
    survivors = surviving_mesh([0, 1], num_kv_heads=H, n_model=1,
                               device="cpu")
    out["mesh0"] = np.array(mesh0.mesh.shape)
    out["mesh1"] = np.array(survivors.mesh.shape)
    if rank >= 2:
        return out                     # this rank "died"
    eb.recover(survivors)
    while not eb.done:
        eb.step()
    got = eb.results()
    out["streams"] = np.array([got[i] for i in range(len(prompts))])
    return out


def case_spec_tp(inp, rank, world, d):
    """SpeculativeEngine over a tensor-parallel target and draft on one
    (1, world) mesh, f32 weights over KIVI-2 with f32 scales and
    windows: greedy generate with a 1-layer draft (the target's first
    layer) and with the target as its own draft, generate_device, a
    sampled run under a seeded generator; and a draft on another mesh,
    refused."""
    import dataclasses

    import torch

    from kivi_tpu_torch.parallel import mesh as M
    from kivi_tpu_torch.parallel import multihost
    from kivi_tpu_torch.serving.engine import Engine
    from kivi_tpu_torch.serving.speculative import SpeculativeEngine

    cfg, p = _cfg(inp), _params(inp, torch.float32)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    pd = dict(p, layers=p["layers"][:1])
    mesh = multihost.global_mesh(cfg.num_kv_heads, n_model=world,
                                 device="cpu")
    nd, dr, nm, mr = M.mesh_coords(mesh)
    q = _qcfg(2, residual=32)

    def engine(c, params, on):
        return Engine(c, q, M.shard_params(params, c, nm, mr),
                      int(inp["max_len"]), 1, device="cpu",
                      cache_dtype=torch.float32, mesh=on)

    tgt, drf = engine(cfg, p, mesh), engine(dcfg, pd, mesh)
    toks = torch.from_numpy(inp["tokens"])
    new = int(inp["new"])
    spec = SpeculativeEngine(tgt, drf, k=int(inp["k"]))
    out = {"coords": np.array([nd, dr, nm, mr]),
           "gen": spec.generate(toks, new),
           "acc": np.array(spec.last_acceptance),
           "keff": np.array(spec.last_keff),
           "stats": np.array([spec.stats[k] for k in (
               "boundary_flush_k", "boundary_flush_v", "clamped")])}
    out["dev"] = spec.generate_device(toks, new)
    g = torch.Generator().manual_seed(0)
    out["sampled"] = spec.generate(toks, new, temperature=0.8, top_k=20,
                                   generator=g)
    own = SpeculativeEngine(tgt, tgt, k=int(inp["k"]))
    out["self"] = own.generate(toks, new)
    out["self_acc"] = np.array(own.last_acceptance)
    other = multihost.global_mesh(cfg.num_kv_heads, n_model=world,
                                  device="cpu")
    try:
        SpeculativeEngine(tgt, engine(dcfg, pd, other), k=2)
        out["refused"] = np.array(0)
    except ValueError:
        out["refused"] = np.array(1)
    return out


CASES = {"mesh_engine": case_mesh_engine, "ring": case_ring,
         "seqpar": case_seqpar, "multihost": case_multihost,
         "elastic": case_elastic, "spec_tp": case_spec_tp}


def _main():
    case, rank, world, d = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    import torch
    import torch.distributed as dist

    from kivi_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize("file://" + os.path.join(d, "store"), world, rank,
                         device="cpu")
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = CASES[case](inp, rank, world, d)
    np.savez(os.path.join(d, f"out{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    _main()
