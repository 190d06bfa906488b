"""Speculative decoding over a tensor-parallel engine: the port's
SpeculativeEngine over `Engine(mesh=)` target and draft, in a gloo
world of 2 processes (tests/torch_dist.py, case "spec_tp", a (1, 2)
mesh), against

  * the JAX package's SpeculativeEngine on one device with the same
    weights (impl="jnp", f32 windows and scales), and over the same
    weights sharded on a (1, 2) mesh of the 8 virtual devices (the JAX
    package has no TP speculative refusal: GSPMD runs it), and
  * the port's own SpeculativeEngine without a mesh.

Greedy: the tokens, the acceptance counts and the clamped depths are
equal on every rank and to both references (a 1-layer draft made of the
target's first layer, so that blocks are accepted and rejected, and the
target as its own draft across flush boundaries); generate_device
equals generate.  Sampled under one seed: the two ranks agree (they see
the same gathered logits).  A draft on another mesh is refused.

Tolerance: none (equal tokens and counts).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import flat_params, spawn

from kivi_tpu.config import QuantConfig as JQuantConfig
from kivi_tpu.config import tiny_config as j_tiny_config
from kivi_tpu.models import modeling as JM
from kivi_tpu.parallel import make_mesh, shard_params
from kivi_tpu.serving.engine import Engine as JEngine
from kivi_tpu.serving.speculative import SpeculativeEngine as JSpec
from kivi_tpu_torch.config import QuantConfig, tiny_config
from kivi_tpu_torch.models.convert import params_from_jax
from kivi_tpu_torch.serving.engine import Engine
from kivi_tpu_torch.serving.speculative import SpeculativeEngine

DIMS = dict(num_heads=8, num_kv_heads=4)
MAX, T, NEW, K = 512, 40, 60, 4
KW = dict(k_bits=2, v_bits=2, group_size=32, residual_length=32,
          scale_dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jparams():
    jp = JM.init_params(j_tiny_config(**DIMS), jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    jd = dict(jp, layers={k: v[:1] for k, v in jp["layers"].items()})
    return jp, jd


def _tokens():
    return np.random.default_rng(3).integers(0, 256, (1, T))


def _jax_spec(mesh=None, self_draft=False):
    jp, jd = _jparams()
    cfg = j_tiny_config(**DIMS)
    dcfg = j_tiny_config(**DIMS, num_layers=1)

    def eng(c, p):
        if mesh is not None:
            p = shard_params(p, c, mesh)
        e = JEngine(cfg=c, qcfg=JQuantConfig(**KW), params=p,
                    max_seq_len=MAX, batch_size=1, impl="jnp")
        e.cache_dtype = jnp.float32
        return e

    t = eng(cfg, jp)
    spec = JSpec(t, t if self_draft else eng(dcfg, jd), k=K)
    out = spec.generate(jnp.asarray(_tokens(), jnp.int32), NEW)
    return out, spec.last_acceptance, spec.last_keff


def _port_spec(self_draft=False):
    jp, jd = _jparams()
    q = QuantConfig(**KW)

    def eng(c, p):
        return Engine(c, q, params_from_jax(_np(p), "cpu", torch.float32),
                      MAX, 1, device="cpu", cache_dtype=torch.float32)

    t = eng(tiny_config(**DIMS), jp)
    d = t if self_draft else eng(tiny_config(**DIMS, num_layers=1), jd)
    spec = SpeculativeEngine(t, d, k=K)
    return (spec.generate(torch.from_numpy(_tokens()), NEW),
            spec.last_acceptance, spec.last_keff)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {"tokens": _tokens(), "new": np.array(NEW), "k": np.array(K),
              "max_len": np.array(MAX),
              **{f"cfg.{k}": np.array(v) for k, v in DIMS.items()},
              **flat_params(_np(_jparams()[0]))}
    return spawn("spec_tp", 2, tmp_path_factory.mktemp("spec_tp"), inputs)


def test_tp_ranks_agree_and_refuse_another_mesh(ranks):
    assert [list(r["coords"]) for r in ranks] == [[1, 0, 2, 0],
                                                  [1, 0, 2, 1]]
    for key in ("gen", "acc", "keff", "stats", "dev", "sampled", "self",
                "self_acc"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    assert all(int(r["refused"]) == 1 for r in ranks)
    assert ranks[0]["sampled"].shape == (1, NEW)


@pytest.mark.parametrize("self_draft", [False, True])
def test_tp_greedy_matches_jax_and_the_single_rank_port(ranks, self_draft):
    gen = ranks[0]["self" if self_draft else "gen"]
    acc = ranks[0]["self_acc" if self_draft else "acc"]
    jout, jacc, jkeff = _jax_spec(self_draft=self_draft)
    tout, tacc, tkeff = _port_spec(self_draft=self_draft)
    np.testing.assert_array_equal(gen, np.asarray(jout))
    np.testing.assert_array_equal(gen, tout)
    assert list(acc) == list(jacc) == list(tacc)
    if not self_draft:
        assert list(ranks[0]["keff"]) == list(jkeff) == list(tkeff)
        assert 0 < sum(acc) < K * len(acc)      # accepts and rejects
    else:
        assert max(acc) == K                    # full accepts, bonus steps


def test_tp_generate_device_equals_generate(ranks):
    np.testing.assert_array_equal(ranks[0]["dev"], ranks[0]["gen"])


def test_jax_spec_over_a_mesh_gives_the_single_device_tokens():
    """The JAX SpeculativeEngine over params sharded on a (1, 2) mesh of
    the virtual devices: the single-device tokens (what the port's TP
    path is held to)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    want = _jax_spec()
    got = _jax_spec(mesh=make_mesh(1, 2))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert list(got[1]) == list(want[1])
