"""The port's per-row sampling controls (kivi_tpu_torch.serving.sampling,
the continuous batcher's variant) against kivi_tpu.serving.sampling on
the same numpy logits and mixed per-row controls.

Tolerances: the penalty is the same f32 operations (equal); the warped
logits and the sampling distributions within 1e-6 (softmax and cumsum
summed in another order by the two libraries).  Draws come from a
torch.Generator, so sampled tokens are checked for their support and,
over many draws, their frequencies against the distribution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kivi_tpu.serving import sampling as JS
from kivi_tpu_torch.serving import sampling as TS

V = 50
# per-row controls: greedy, top-k, top-p, both, top_k >= V, t <= 0 with
# filters (greedy), a strong temperature
TEMP = np.array([0.0, 0.7, 1.3, 0.9, 1.0, -1.0, 3.0], np.float32)
TOPK = np.array([0, 5, 0, 7, 60, 3, 1], np.int32)
TOPP = np.array([1.0, 1.0, 0.8, 0.5, 0.95, 0.3, 1.0], np.float32)


def _logits(seed):
    x = np.random.default_rng(seed).standard_normal(
        (len(TEMP), V)).astype(np.float32) * 3
    x[1, 4] = x[1, 9]                       # a tie inside the top-k
    return x


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_and_probs_per_row_match_jax(seed):
    x = _logits(seed)
    want = JS.warp_logits_per_row(jnp.asarray(x), jnp.asarray(TEMP),
                                  jnp.asarray(TOPK), jnp.asarray(TOPP))
    got = TS.warp_logits_per_row(*_t(x, TEMP, TOPK, TOPP))
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(want)[fin],
                               rtol=1e-6, atol=1e-6)
    want_p = JS.probs_per_row(jnp.asarray(x), jnp.asarray(TEMP),
                              jnp.asarray(TOPK), jnp.asarray(TOPP))
    got_p = TS.probs_per_row(*_t(x, TEMP, TOPK, TOPP))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-6, atol=1e-6)
    # greedy rows (temperature <= 0) are one-hot at the argmax
    for b in np.nonzero(TEMP <= 0)[0]:
        assert got_p[b].argmax() == int(x[b].argmax())
        assert got_p[b].max() == 1.0 and got_p[b].sum() == 1.0


def test_penalty_per_row_matches_jax():
    x = _logits(3)
    seen = np.random.default_rng(4).random((len(TEMP), V)) < 0.3
    pen = np.array([1.0, 1.3, 0.8, 2.0, 1.0, 1.1, 1.5], np.float32)
    want = JS.apply_repetition_penalty_per_row(
        jnp.asarray(x), jnp.asarray(seen), jnp.asarray(pen))
    got = TS.apply_repetition_penalty_per_row(*_t(x, seen, pen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got[0], torch.from_numpy(x[0]))    # penalty 1


def test_sample_step_per_row_greedy_support_and_masked_rows():
    x = _logits(5)
    gen = torch.Generator().manual_seed(0)
    support = np.isfinite(np.asarray(JS.warp_logits_per_row(
        jnp.asarray(x), jnp.asarray(TEMP), jnp.asarray(TOPK),
        jnp.asarray(TOPP))))
    for _ in range(20):
        tok = TS.sample_step_per_row(torch.from_numpy(x), gen,
                                     *_t(TEMP, TOPK, TOPP))
        assert tok.dtype == torch.int32 and tok.shape == (len(TEMP),)
        # greedy rows and top_k = 1 rows are the argmax
        for b in (0, 5, 6):
            assert int(tok[b]) == int(x[b].argmax())
        assert support[np.arange(len(TEMP)), tok.numpy()].all()
    # a row whose logits are all masked neither raises nor leaves the
    # vocabulary (torch.multinomial would raise on it)
    y = x.copy()
    y[2] = -np.inf
    tok = TS.sample_step_per_row(torch.from_numpy(y), gen,
                                 *_t(TEMP, TOPK, TOPP))
    assert 0 <= int(tok[2]) < V


def test_sample_step_per_row_frequencies():
    """Gumbel-max draws follow probs_per_row: 4000 draws of two sampled
    rows, every token's frequency within 0.03 of its probability (about
    four standard deviations)."""
    x = np.random.default_rng(6).standard_normal((2, 6)).astype(np.float32)
    t, k, p = (np.array([1.0, 0.8], np.float32), np.array([0, 4], np.int32),
               np.array([1.0, 0.9], np.float32))
    lx = torch.from_numpy(np.repeat(x, 2000, axis=0))
    rep = [torch.from_numpy(np.repeat(a, 2000)) for a in (t, k, p)]
    tok = TS.sample_step_per_row(lx, torch.Generator().manual_seed(1), *rep)
    probs = TS.probs_per_row(*_t(x, t, k, p)).numpy()
    for b in range(2):
        freq = np.bincount(tok[b * 2000:(b + 1) * 2000].numpy(),
                           minlength=6) / 2000
        np.testing.assert_allclose(freq, probs[b], atol=0.03)
