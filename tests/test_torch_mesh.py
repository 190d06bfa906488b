"""The port's (data, model) mesh (kivi_tpu_torch.parallel.mesh) and
Engine(mesh=) against the JAX package's mesh on 8 virtual CPU devices
(kivi_tpu.parallel.mesh; tests/test_parallel.py:33-86).

  * auto_mesh_shape equals the JAX package's on a grid;
  * the pure slicing functions (shard_params, shard_caches,
    shard_tokens) give, at every (data, model) coordinate of a (2, 4)
    mesh, exactly the addressable shard the JAX NamedSharding puts on
    that device (bit for bit);
  * Engine(mesh=) in gloo worlds of 4 processes, a (2, 2) mesh, and of
    2, a (1, 2) mesh (tests/torch_dist.py): teacher-forced prefill,
    decode and prefix-extend logits of each rank's rows against the JAX
    engine over sharded params on the same mesh shape and against the
    port's own single-rank engine, within 2e-4 at f32 weights and
    caches (both differ from the whole-model run by f32 summation
    order: the JAX package's all-reduces where XLA put them, the
    port's after each row-parallel projection), on KIVI-2 and fp16 (but
    the fp16 cache's decode against the JAX engine: 2e-2, the JAX
    package's own bound for its `impl="jnp"` fp decode, which rounds the
    query and the probabilities to bf16, tests/test_kernels.py:170, as
    tests/test_torch_engine.py holds it);
    the ranks of a model group bit-identical (the logits are gathered,
    not reduced); load_checkpoint(mesh=) equal to shard_params of the
    whole checkpoint on every rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.cache.kivi_cache import broadcast_rows as j_broadcast_rows
from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.parallel import mesh as JMESH
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu_torch.cache import kivi_cache as KC
from kivi_tpu_torch.cache.fp_cache import FpLayerCache
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models import checkpoint
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.parallel import mesh as M
from kivi_tpu_torch.serving.engine import Engine
from torch_dist import flat_params, spawn

torch.set_num_threads(2)

DIMS = dict(num_heads=8, num_kv_heads=4, head_dim=32, hidden_size=128)
B, T, STEPS, MAX = 4, 48, 4, 256


def _qcfgs(bits):
    kw = dict(k_bits=bits, v_bits=bits, group_size=32, residual_length=64,
              scale_dtype="float32")
    return JQuantConfig(**kw), QuantConfig(**kw)


def _jparams():
    return JM.init_params(j_tiny_config(**DIMS), jax.random.PRNGKey(0),
                          dtype=jnp.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmesh(nd, nm):
    if len(jax.devices()) < nd * nm:
        pytest.skip("needs 8 virtual devices")
    return JMESH.make_mesh(nd, nm)


def _shard_at(arr, mesh, d, m):
    """The JAX array's shard on the device at mesh coordinate (d, m)."""
    dev = mesh.devices[d, m]
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


def test_auto_mesh_shape_matches_jax():
    for n in range(1, 17):
        for h in (1, 2, 3, 4, 6, 8, 32):
            assert M.auto_mesh_shape(n, h) == JMESH.auto_mesh_shape(n, h)


def test_local_config_refuses_an_indivisible_axis():
    cfg = tiny_config(**DIMS)
    lc = M.local_config(cfg, 4)
    assert (lc.num_heads, lc.num_kv_heads, lc.intermediate_size,
            lc.head_dim, lc.vocab_size) == (2, 1, 64, 32, 256)
    with pytest.raises(ValueError, match="num_kv_heads"):
        M.local_config(tiny_config(num_heads=6, num_kv_heads=3), 2)
    with pytest.raises(ValueError, match="batch"):
        M.local_batch(3, 2)


def test_param_shards_match_jax():
    mesh = _jmesh(2, 4)
    jp = _jparams()
    sharded = JMESH.shard_params(jp, j_tiny_config(**DIMS), mesh)
    tp = params_from_jax(_np(jp), "cpu", torch.float32)
    for d in range(2):
        for m in range(4):
            got = M.shard_params(tp, tiny_config(**DIMS), 4, m)
            for k in ("embed", "ln_f", "lm_head"):
                np.testing.assert_array_equal(
                    got[k].numpy(), _shard_at(sharded[k], mesh, d, m))
            for k, arr in sharded["layers"].items():
                want = _shard_at(arr, mesh, d, m)
                np.testing.assert_array_equal(
                    np.stack([lp[k].numpy() for lp in got["layers"]]), want,
                    err_msg=f"{k} at ({d}, {m})")


def _port_cache(jc):
    """A JAX layer cache as the port's (same field names and layouts)."""
    cls = FpLayerCache if hasattr(jc, "length") else KC.KiviLayerCache
    kw = {}
    for f in dataclasses.fields(cls):
        x = np.asarray(getattr(jc, f.name))
        kw[f.name] = (int(x) if x.ndim == 0 else
                      torch.from_numpy((x.view(np.int32) if x.dtype
                                        == np.uint32 else x).copy()))
    return cls(**kw)


@pytest.mark.parametrize("bits", [2, 16])
def test_cache_and_token_shards_match_jax(bits):
    mesh = _jmesh(2, 4)
    jq, tq = _qcfgs(bits)
    jp = _jparams()
    eng = JEngine(cfg=j_tiny_config(**DIMS), qcfg=jq, params=jp,
                  max_seq_len=MAX, batch_size=B, impl="jnp")
    eng.cache_dtype = jnp.float32
    toks = jnp.asarray(np.random.default_rng(1).integers(0, 256, (B, T)),
                       jnp.int32)
    _, caches = eng._prefill(jp, toks, eng.init_caches())
    port = [_port_cache(c) for c in caches]
    sharded = JMESH.shard_caches(caches, jq, mesh)
    stoks = JMESH.shard_tokens(toks, mesh)
    for d in range(2):
        for m in range(4):
            got = M.shard_caches(port, tq, 2, d, 4, m)
            for g, jc in zip(got, sharded):
                for f in dataclasses.fields(g):
                    x, want = getattr(g, f.name), _shard_at(
                        getattr(jc, f.name), mesh, d, m)
                    if isinstance(x, int):
                        assert x == int(want), f.name
                    else:
                        np.testing.assert_array_equal(
                            x.numpy().view(want.dtype), want,
                            err_msg=f"{f.name} at ({d}, {m})")
            np.testing.assert_array_equal(
                M.shard_tokens(torch.from_numpy(np.array(toks)), 2,
                               d).numpy(), _shard_at(stoks, mesh, d, m))


# ---------------------------------------------------------------------------
# Engine(mesh=) over gloo worlds
# ---------------------------------------------------------------------------

def _inputs(tmp):
    rng = np.random.default_rng(7)
    jp = _jparams()
    tp = params_from_jax(_np(jp), "cpu", torch.float32)
    checkpoint.save_checkpoint(str(tmp / "ckpt"), tp, tiny_config(**DIMS))
    return {"tokens": rng.integers(0, 256, (B, T)),
            "steps": rng.integers(0, 256, (B, STEPS)),
            "prefix": rng.integers(1, 256, (40,)),
            "suffix": rng.integers(1, 256, (B, 16)),
            "max_len": np.array(MAX), "batch": np.array(B),
            "ckpt": np.array(str(tmp / "ckpt")),
            **{f"cfg.{k}": np.array(v) for k, v in DIMS.items()},
            **flat_params(_np(jp))}


def _jax_run(inp, bits, mesh):
    """Prefill, STEPS teacher-forced decode steps and the prefix extend
    through the JAX engine: over sharded params on `mesh`, or whole."""
    jq, _ = _qcfgs(bits)
    jp = _jparams()
    cfg = j_tiny_config(**DIMS)
    eng = JEngine(cfg=cfg, qcfg=jq, params=jp, max_seq_len=MAX,
                  batch_size=B, impl="jnp")
    eng.cache_dtype = jnp.float32
    if mesh is None:
        p, put, caches = jp, (lambda x: x), eng.init_caches()
    else:
        p = JMESH.shard_params(jp, cfg, mesh)
        put = lambda x: JMESH.shard_tokens(x, mesh)   # noqa: E731
        caches = JMESH.shard_caches(eng.init_caches(), jq, mesh)
    out = {}
    lg, caches = eng._prefill(p, put(jnp.asarray(inp["tokens"], jnp.int32)),
                              caches)
    out["prefill"] = np.asarray(lg)
    dec = []
    for i in range(STEPS):
        pos = jnp.full((B, 1), T + i, jnp.int32)
        lg, caches = eng._decode(p, put(jnp.asarray(inp["steps"][:, i:i + 1],
                                                    jnp.int32)), pos, caches)
        dec.append(np.asarray(lg))
    out["decode"] = np.stack(dec)
    snap = eng.prefill_prefix(jnp.asarray(inp["prefix"], jnp.int32))
    caches = [j_broadcast_rows(c, B) for c in snap.caches]
    if mesh is not None:
        caches = JMESH.shard_caches(caches, jq, mesh)
    lg, _ = eng._extend_call(p, put(jnp.asarray(inp["suffix"], jnp.int32)),
                             caches, snap.length)
    out["extend"] = np.asarray(lg)
    return out


def _port_single(inp, bits):
    """The port's own single-rank engine, the same steps."""
    _, tq = _qcfgs(bits)
    tp = params_from_jax(_np(_jparams()), "cpu", torch.float32)
    eng = Engine(tiny_config(**DIMS), tq, tp, MAX, B, device="cpu",
                 cache_dtype=torch.float32)
    out = {}
    lg, caches = eng._prefill(torch.from_numpy(inp["tokens"]))
    out["prefill"] = lg.numpy()
    dec = []
    steps = torch.from_numpy(inp["steps"])
    for i in range(STEPS):
        lg, caches = eng.decode_step(steps[:, i:i + 1],
                                     torch.full((B, 1), T + i), caches)
        dec.append(lg.numpy())
    out["decode"] = np.stack(dec)
    snap = eng.prefill_prefix(torch.from_numpy(inp["prefix"]))
    lg, _ = eng._extend(torch.from_numpy(inp["suffix"]),
                        [KC.broadcast_rows(c, B) for c in snap.caches],
                        snap.length)
    out["extend"] = lg.numpy()
    return out


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    """(nd, nm) -> each rank's results, spawned once per shape."""
    runs = {}

    def get(nd, nm):
        if (nd, nm) not in runs:
            tmp = tmp_path_factory.mktemp(f"mesh{nd}{nm}")
            inp = {**_inputs(tmp), "n_model": np.array(nm)}
            runs[nd, nm] = (inp, spawn("mesh_engine", nd * nm, tmp, inp))
        return runs[nd, nm]
    return get


@pytest.mark.parametrize("bits", [2, 16])
@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_mesh_engine_matches_jax_and_single_rank(world_runs, shape, bits):
    nd, nm = shape
    inp, outs = world_runs(nd, nm)
    want = _jax_run(inp, bits, _jmesh(nd, nm))
    single = _port_single(inp, bits)
    Bl = B // nd
    for o in outs:
        n_d, d, n_m, m = (int(x) for x in o["coords"])
        assert (n_d, n_m) == (nd, nm)
        rows = slice(d * Bl, (d + 1) * Bl)
        for what in ("prefill", "decode", "extend"):
            got = o[f"{what}{bits}"]
            r = (slice(None), rows) if what == "decode" else (rows,)
            for ref, name in ((want, "JAX mesh"), (single, "port 1 rank")):
                tol = (2e-2 if (bits, what, name) == (16, "decode",
                                                      "JAX mesh") else 2e-4)
                np.testing.assert_allclose(
                    got, ref[what][r], rtol=tol, atol=tol,
                    err_msg=f"{what} vs {name} at rank ({d}, {m})")
        # the model group's ranks: the same bits
        peer = next(p for p in outs if int(p["coords"][1]) == d)
        for what in ("prefill", "decode", "extend"):
            np.testing.assert_array_equal(o[f"{what}{bits}"],
                                          peer[f"{what}{bits}"])
        assert bool(o["ckpt_equal"])
