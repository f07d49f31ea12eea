"""The port's sampler against simplellminference_tpu.ops.sampling.

Greedy rows, penalties and logit bias must be exact; sampled rows draw
different random bits in the two packages (threefry keys vs the port's
counter hash), so they are checked by distribution: 20000 seeded draws at
distinct positions against the JAX package's shaped probabilities
(``shaped_token_prob``), total-variation distance below 0.02.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops import sampling as jsamp
from simplellminference_tpu_torch.ops import sampling as tsamp


def _logits(rng, b, v):
    return (rng.standard_normal((b, v)) * 2).astype(np.float32)


def test_greedy_exact():
    lg = _logits(np.random.default_rng(0), 6, 300)
    np.testing.assert_array_equal(tsamp.greedy(torch.from_numpy(lg)).numpy(),
                                  np.asarray(jsamp.greedy(jnp.asarray(lg))))


def test_penalties_and_bias_exact():
    rng = np.random.default_rng(1)
    lg = _logits(rng, 4, 64)
    counts = rng.integers(0, 3, (4, 64)).astype(np.float32)
    rp = np.asarray([1.0, 1.3, 0.8, 2.0], np.float32)
    fp = np.asarray([0.0, 0.5, 0.1, 0.0], np.float32)
    pp = np.asarray([0.0, 0.2, 0.0, 1.0], np.float32)
    got = tsamp.apply_penalties(*(torch.from_numpy(a) for a in (
        lg, counts, rp, fp, pp)))
    want = jsamp.apply_penalties(*(jnp.asarray(a) for a in (
        lg, counts, rp, fp, pp)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = np.asarray([[3, -1, 3], [0, 63, -1], [-1, -1, -1], [10, 11, 12]],
                     np.int32)
    vals = rng.standard_normal((4, 3)).astype(np.float32)
    got = tsamp.apply_logit_bias(*(torch.from_numpy(a) for a in (
        lg, ids, vals)))
    want = jsamp.apply_logit_bias(*(jnp.asarray(a) for a in (
        lg, ids, vals)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("flags", [None, "host"])
def test_greedy_rows_with_penalties_and_bias_match_jax(flags):
    rng = np.random.default_rng(2)
    b, v = 5, 80
    lg = _logits(rng, b, v)
    temp = np.asarray([0, 0, 0.9, 0, 1.2], np.float32)
    top_k = np.asarray([0, 0, 5, 0, 0], np.int32)
    top_p = np.ones(b, np.float32)
    counts = rng.integers(0, 2, (b, v)).astype(np.float32)
    rp = np.asarray([1.2, 1.0, 1.0, 1.5, 1.0], np.float32)
    fp = np.zeros(b, np.float32)
    pp = np.asarray([0.0, 0.7, 0.0, 0.0, 0.0], np.float32)
    ids = np.full((b, 2), -1, np.int32)
    ids[1] = [7, 9]
    vals = np.asarray([[0, 0], [5.0, -100.0], [0, 0], [0, 0], [0, 0]],
                      np.float32)
    seeds = np.arange(b, dtype=np.int64) + 11
    pos = np.full(b, 40, np.int32)
    kw = {}
    if flags == "host":
        kw = dict(all_greedy=False, penalties_on=True, shaping_on=True)
    got = tsamp.sample(
        torch.from_numpy(lg), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        counts=torch.from_numpy(counts),
        repetition_penalty=torch.from_numpy(rp),
        frequency_penalty=torch.from_numpy(fp),
        presence_penalty=torch.from_numpy(pp), seeds=torch.from_numpy(seeds),
        seed_pos=torch.from_numpy(pos), bias_ids=torch.from_numpy(ids),
        bias_vals=torch.from_numpy(vals), **kw).numpy()
    want = np.asarray(jsamp.sample(
        jnp.asarray(lg), jax.random.PRNGKey(0), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), counts=jnp.asarray(counts),
        repetition_penalty=jnp.asarray(rp), frequency_penalty=jnp.asarray(fp),
        presence_penalty=jnp.asarray(pp),
        seeds=jnp.asarray(seeds.astype(np.uint32)),
        seed_pos=jnp.asarray(pos), bias_ids=jnp.asarray(ids),
        bias_vals=jnp.asarray(vals)))
    greedy_rows = temp <= 0
    np.testing.assert_array_equal(got[greedy_rows], want[greedy_rows])
    assert got.dtype == np.int32


@pytest.mark.parametrize("temp,top_k,top_p,min_p", [
    (1.0, 0, 1.0, 0.0),       # sort-free Gumbel tier
    (0.7, 3, 1.0, 0.0),       # top-k
    (1.3, 0, 0.8, 0.0),       # top-p
    (1.0, 0, 1.0, 0.1),       # min-p
], ids=["temperature", "top_k", "top_p", "min_p"])
def test_sampled_rows_match_shaped_distribution(temp, top_k, top_p, min_p):
    v, n = 12, 20000
    row = _logits(np.random.default_rng(3), 1, v) * 0.3   # a flat row
    lg = np.repeat(row, n, axis=0)

    def full(x, dt):
        return np.full(n, x, dt)

    got = tsamp.sample(
        torch.from_numpy(lg), torch.from_numpy(full(temp, np.float32)),
        torch.from_numpy(full(top_k, np.int32)),
        torch.from_numpy(full(top_p, np.float32)),
        min_p=torch.from_numpy(full(min_p, np.float32)),
        seeds=torch.from_numpy(full(1234, np.int64)),
        seed_pos=torch.arange(n, dtype=torch.int32)).numpy()
    emp = np.bincount(got, minlength=v) / n
    want = np.asarray([float(jsamp.shaped_token_prob(
        jnp.asarray(row), jnp.asarray([t]), jnp.asarray([temp]),
        jnp.asarray([top_k]), jnp.asarray([top_p]),
        jnp.asarray([min_p]))[0]) for t in range(v)])
    assert (want > 0).sum() >= 3                # the filters leave a choice
    assert emp[want == 0].sum() == 0            # filtered tokens never drawn
    assert 0.5 * np.abs(emp - want).sum() < 0.02


def test_seeded_draws_ignore_batch_composition():
    rng = np.random.default_rng(4)
    lg = _logits(rng, 6, 50)
    kw = dict(temperature=torch.full((6,), 1.0), top_k=torch.zeros(6,
                                                                   dtype=torch.int32),
              top_p=torch.ones(6))
    seeds = torch.tensor([5, 6, 7, 8, 9, 10])
    pos = torch.tensor([3, 3, 9, 1, 0, 77], dtype=torch.int32)
    a = tsamp.sample(torch.from_numpy(lg), seeds=seeds, seed_pos=pos, **kw)
    perm = torch.tensor([5, 2, 0, 4, 1, 3])
    b = tsamp.sample(torch.from_numpy(lg)[perm], seeds=seeds[perm],
                     seed_pos=pos[perm], **kw)
    assert torch.equal(a[perm], b)
    c = tsamp.sample(torch.from_numpy(lg), seeds=seeds, seed_pos=pos + 1,
                     **kw)
    assert not torch.equal(a, c)


def test_token_logprob():
    rng = np.random.default_rng(5)
    lg = _logits(rng, 3, 40)
    tok = np.asarray([0, 17, 39], np.int32)
    np.testing.assert_allclose(
        tsamp.token_logprob(torch.from_numpy(lg),
                            torch.from_numpy(tok)).numpy(),
        np.asarray(jsamp.token_logprob(jnp.asarray(lg), jnp.asarray(tok))),
        rtol=1e-5, atol=1e-6)


# Tied logits: the JAX package sorts ascending (stable) and reverses
# (sampling.py:89-92), so ties rank in descending token id, and a top-k
# or top-p cut inside a tie keeps the highest ids. The port must keep the
# same tokens.
TIES = [(np.asarray([0.0, 0.0, 0.0, -5.0], np.float32), 1, 1.0),
        (np.asarray([0.0, 0.0, 0.0, -5.0], np.float32), 2, 1.0),
        (np.asarray([1.0, 0.0, 0.0, 0.0, 0.0, -3.0], np.float32), 0, 0.6)]


def _jax_kept(row, top_k, top_p):
    """Tokens JAX's ``_shaped_sorted`` keeps for one row (temperature 1)."""
    masked, si = jsamp._shaped_sorted(
        jnp.asarray(row[None]), jnp.ones(1), jnp.asarray([top_k], jnp.int32),
        jnp.asarray([top_p], jnp.float32), jnp.zeros(1))
    keep = np.isfinite(np.asarray(masked[0]))
    return set(np.asarray(si[0])[keep].tolist())


def _rows(row, top_k, top_p, n=1):
    return (torch.from_numpy(np.repeat(row[None], n, 0)),
            torch.ones(n), torch.full((n,), top_k, dtype=torch.int32),
            torch.full((n,), top_p), torch.zeros(n))


@pytest.mark.parametrize("row,top_k,top_p", TIES,
                         ids=["top_k1", "top_k2", "top_p_inside_tie"])
def test_tied_logits_keep_jax_tokens(row, top_k, top_p):
    kept = _jax_kept(row, top_k, top_p)
    v = len(row)
    n = 512
    lg, temp, tk, tp, mp = _rows(row, top_k, top_p, n)
    # sample: the drawn set is JAX's kept set (every kept token shows)
    got = tsamp.sample(lg, temp, tk, tp, min_p=mp,
                       seeds=torch.full((n,), 7, dtype=torch.int64),
                       seed_pos=torch.arange(n, dtype=torch.int32))
    assert set(got.tolist()) == kept
    # shaped_token_prob: the same probability of every token as JAX
    for t in range(v):
        args = [torch.from_numpy(row[None]), torch.tensor([t]), temp[:1],
                tk[:1], tp[:1], mp[:1]]
        want = float(jsamp.shaped_token_prob(
            jnp.asarray(row[None]), jnp.asarray([t]), jnp.ones(1),
            jnp.asarray([top_k], jnp.int32),
            jnp.asarray([top_p], jnp.float32), jnp.zeros(1))[0])
        assert abs(float(tsamp.shaped_token_prob(*args)[0]) - want) < 1e-6
        assert (want > 0) == (t in kept)
    # sample_excluding: draws stay in JAX's kept set minus the excluded
    # token (or the kept set when excluding empties it)
    for ex in range(-1, v):
        keys = tsamp.spec_row_keys(torch.full((n,), 3, dtype=torch.int64),
                                   torch.arange(n), 2)
        got = tsamp.sample_excluding(lg, temp, tk, tp, mp,
                                     torch.full((n,), ex), keys)
        want = (kept - {ex}) or kept
        assert set(got.tolist()) == want, (ex, want)
