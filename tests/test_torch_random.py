"""heat_tpu_torch's random draws against heat_tpu's, on the CPU, at world
size 1 (the draws across four ranks are tests/test_torch_dist.py's).

The port's generator is heat_tpu's threefry-2x32 stream: the same
``seed`` and call sequence must give heat_tpu's values. Golden values come
from heat_tpu (and ``jax.random``) inside each test. Exact: the keys
(``PRNGKey``, ``fold_in``, ``split``), the 32- and 64-bit bits at any
chunk's indices, ``rand`` and ``uniform`` in float32 and float64,
``randint`` (jax's 64-bit modular combination, at spans up to 2^64 - 1),
``randperm``/``permutation`` (a stable sort whose 32-bit keys collide at
n = 2^20), the state's counter, and KMeans' starting rows.

``randn``/``normal`` within NORMAL_ULPS of heat_tpu's value: the port
evaluates XLA's erfinv polynomials, but its ``log1p`` is torch's, which
rounds otherwise than XLA's (XLA's float64 ``log1p`` is the less accurate
of the two on [-0.7, -0.3]); ``test_normal_draws_over_many_samples``
holds 2^18 draws of each type, tails included, to the bound.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.core import random as port_random
from heat_tpu_torch.core.kernels.threefry import chunk_layout, threefry_bits, threefry_plain

NORMAL_ULPS = {"float32": 4.0, "float64": 32.0}
# (seed, counter) pairs: a seed past 32 bits, a negative one, and a counter about to wrap its 31-bit fold-in
STATES = [(0, 0), (5, 17), (2**40 + 7, 0x7FFFFFF0), (-3, 2**31 + 5)]


@pytest.fixture
def cpu():
    htt.use_device("cpu")
    htt.kernels.reset_kernel_stats()
    try:
        yield htt.cpu
    finally:
        htt.use_device(None)


def _key_words(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def _both(fn, state):
    """``fn(ht)`` on both packages from ``state``; heat_tpu at world size 1."""
    out = []
    for ht in (htj, htt):
        ht.random.set_state(("Threefry",) + tuple(state))
        with comm_context(SELF) if ht is htj else contextlib.nullcontext():
            r = fn(ht)
            out.append((r, ht.random.get_state()))
    (j, sj), (t, st) = out
    assert st == sj
    assert t.dtype.__name__ == j.dtype.__name__ and tuple(t.gshape) == tuple(j.gshape) and t.split == j.split
    return t.numpy(), j.numpy()


# ------------------------------------------------------------------ keys
@pytest.mark.parametrize("seed", [0, 1, 42, 2**32 + 7, 2**63 - 1, -3])
def test_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert port_random._prng_key(seed) == _key_words(key)
    for data in (0, 1, 12345, 0x7FFFFFFF, 2**32 - 1):
        assert port_random._fold_in(port_random._prng_key(seed), data) == _key_words(jax.random.fold_in(key, data))
    assert port_random._split(port_random._prng_key(seed), 5) == [_key_words(k) for k in jax.random.split(key, 5)]


@pytest.mark.parametrize("kind,dtype", [("bits32", jax.numpy.uint32), ("bits64", jax.numpy.uint64)])
@pytest.mark.parametrize(
    "shape,split,chunk",
    [((37,), None, None), ((9, 5), 1, (2, 2)), ((9, 5), 1, (4, 1)), ((7, 3), 0, (2, 3)), ((4, 5, 6), 1, (1, 3)),
     ((4, 5, 6), 2, (5, 1)), ((3, 4), 0, (3, 0))],
)
def test_bits_at_a_chunks_indices_match_jax(kind, dtype, shape, split, chunk):
    """A chunk ``[offset, offset + length)`` along ``split`` of a draw holds
    the bits of those elements of jax's whole draw, split or not."""
    key = (0x12345678, 0x9ABCDEF0)
    whole = np.asarray(jax.random.bits(jax.random.wrap_key_data(np.array(key, np.uint32)), shape, dtype))
    if split is None:
        want, layout, lshape = whole, chunk_layout(shape, None, 0, 0), shape
    else:
        off, length = chunk
        idx = [slice(None)] * len(shape)
        idx[split] = slice(off, off + length)
        want = whole[tuple(idx)]
        layout = chunk_layout(shape, split, off, length)
        lshape = want.shape
    got = threefry_plain(key, layout, kind).reshape(lshape).numpy()
    np.testing.assert_array_equal(got.view(want.dtype), want)
    assert torch.equal(threefry_bits(key, layout, kind, "cpu"), threefry_plain(key, layout, kind))


@pytest.mark.parametrize(
    "v", [0, 1, 12345, 2**32, 2**62 + 3, 2**63 - 1, -(2**63), -1, -2, -(2**62) - 5, -(2**32) + 7]
)
def test_unsigned_remainder_at_the_edges(v):
    """``_urem`` reads int64 bits as unsigned 64-bit, for any span jax's
    ``randint`` can use; its result is unsigned too (as int64 bits)."""
    spans = [1, 3, 7919, 2**31, 2**32, 2**32 + 1, 2**62 + 7, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 1]
    t = torch.tensor([v], dtype=torch.int64)
    for s in spans:
        assert int(port_random._urem(t, s)[0]) % 2**64 == (v % 2**64) % s, (v, s)


# ----------------------------------------------------------------- draws
EXACT_DRAWS = {
    "rand": lambda ht: ht.random.rand(7, 5),
    "rand64": lambda ht: ht.random.rand(6, 4, dtype=ht.float64),
    "rand_scalar": lambda ht: ht.random.rand(),
    "rand_split1": lambda ht: ht.random.rand(9, 5, split=1),
    "uniform": lambda ht: ht.random.uniform(-2.5, 3.25, size=(11, 3)),
    "uniform64": lambda ht: ht.random.uniform(1.0, 7.0, size=(13,), dtype=ht.float64),
    "random_sample": lambda ht: ht.random.random_sample((4, 6), split=0),
    "ranf": lambda ht: ht.random.ranf((5,)),
    "sample": lambda ht: ht.random.sample(),
    "randint": lambda ht: ht.random.randint(-5, 13, size=(40,)),
    "randint_one": lambda ht: ht.random.randint(7, size=(3, 3)),
    "randint_span1": lambda ht: ht.random.randint(4, 5, size=(6,)),
    "randint_2^31+5": lambda ht: ht.random.randint(0, 2**31 + 5, size=(30,), dtype=ht.int64),
    "randint_2^32": lambda ht: ht.random.randint(-(2**31), 2**31, size=(30,), dtype=ht.int64),
    "randint_2^40": lambda ht: ht.random.randint(0, 2**40, size=(20,), dtype=ht.int64),
    "randint_near_2^63": lambda ht: ht.random.randint(-(2**62), 2**62 + 12345, size=(30,), dtype=ht.int64),
    "randint_near_2^64": lambda ht: ht.random.randint(-(2**63) + 1, 2**63 - 1, size=(30,), dtype=ht.int64),
    "random_integer": lambda ht: ht.random.random_integer(3, 9, size=(8,), split=0),
    "randperm": lambda ht: ht.random.randperm(1000),
    "randperm_int32": lambda ht: ht.random.randperm(17, dtype=ht.int32, split=0),
    "permutation_int": lambda ht: ht.random.permutation(12),
    "permutation_rows": lambda ht: ht.random.permutation(ht.array(np.arange(36, dtype=np.float32).reshape(12, 3))),
    "sequence": lambda ht: (ht.random.rand(3), ht.random.randn(2), ht.random.randint(0, 5, size=(4,)),
                            ht.random.rand(2, 2))[-1],
}


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("name", sorted(EXACT_DRAWS))
def test_draw_matches_heat_tpu_exactly(cpu, name, state):
    got, want = _both(EXACT_DRAWS[name], state)
    np.testing.assert_array_equal(got, want)


NORMAL_DRAWS = {
    "randn": lambda ht: ht.random.randn(64, 9),
    "randn64": lambda ht: ht.random.randn(64, 9, dtype=ht.float64),
    "randn_split0": lambda ht: ht.random.randn(33, 4, split=0),
    "normal": lambda ht: ht.random.normal(1.5, 0.25, shape=(20, 3)),
    "normal64": lambda ht: ht.random.normal(-2.0, 3.0, shape=(20,), dtype=ht.float64),
    "standard_normal": lambda ht: ht.random.standard_normal((5, 7)),
    "randn_scalar": lambda ht: ht.random.randn(),
}


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("name", sorted(NORMAL_DRAWS))
def test_normal_draw_matches_heat_tpu_within_ulps(cpu, name, state):
    got, want = _both(NORMAL_DRAWS[name], state)
    ulps = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))
    assert float(ulps.max()) <= NORMAL_ULPS[want.dtype.name], float(ulps.max())


def test_normal_draws_over_many_samples(cpu):
    """2^18 draws of each type: every one within NORMAL_ULPS, the tails
    (|x| > 3, where XLA's erfinv takes its second polynomial) included."""
    for name in ("float32", "float64"):
        got, want = _both(lambda ht: ht.random.randn(1 << 18, dtype=getattr(ht, name)), (11, 0))
        ulps = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))
        assert float(ulps.max()) <= NORMAL_ULPS[name], (name, float(ulps.max()))
        assert (np.abs(want) > 3).sum() > 100


def test_permutation_orders_colliding_keys_as_heat_tpu(cpu):
    """At n = 2^20 the first round's 32-bit sort keys collide; the stable
    sort keeps them in heat_tpu's order."""
    n = 1 << 20
    key = port_random._fold_in(port_random._prng_key(9), 0)
    sub = port_random._split(key)[1]
    first_keys = threefry_plain(sub, chunk_layout((n,), None, 0, 0), "bits32")
    assert first_keys.unique().numel() < n  # collisions exist
    got, want = _both(lambda ht: ht.random.randperm(n), (9, 0))
    np.testing.assert_array_equal(got, want)


def test_state_round_trip_and_errors(cpu):
    for ht in (htj, htt):
        ht.random.seed(123)
    assert htt.random.get_state() == htj.random.get_state() == ("Threefry", 123, 0, 0, 0.0)
    htt.random.rand(4, 5)
    assert htt.random.get_state()[2] == 20
    htt.random.set_state(("Threefry", 7, 99))
    assert htt.random.get_state() == ("Threefry", 7, 99, 0, 0.0)
    with pytest.raises(TypeError):
        htt.random.set_state(["Threefry", 7, 99])
    with pytest.raises(ValueError):
        htt.random.set_state(("MT19937", 7, 99))
    with pytest.raises(ValueError):
        htt.random.rand(3, dtype=htt.int32)
    with pytest.raises(ValueError):
        htt.random.randint(5, 5)
    with pytest.raises(TypeError):
        htt.random.permutation([1, 2, 3])
    # the top-level names are the module's
    assert htt.rand is htt.random.rand and htt.seed is htt.random.seed and htt.permutation is htt.random.permutation


# ---------------------------------------------------------------- KMeans
def _blobs(seed, n, f, k):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, f)) * 10.0).astype(np.float32)
    return (centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, f))).astype(np.float32)


@pytest.mark.parametrize("init", ["random", "kmeans++", "probability_based"])
@pytest.mark.parametrize("n,f,k,random_state", [(203, 5, 3, 0), (1000, 4, 8, 5), (5000, 3, 12, 123)])
def test_kmeans_initial_and_final_centres_match_heat_tpu(cpu, init, n, f, k, random_state):
    """The starting rows exactly (kmeans++'s float32 CDF adds in another
    order than XLA's, so at large n a draw could land on a neighbouring
    row; at these sizes it does not), and the fitted centres to float32
    reassociation of the Lloyd sums."""
    x = _blobs(n, n, f, k)
    with comm_context(SELF):
        kj = htj.cluster.KMeans(k, init=init, random_state=random_state, max_iter=10, tol=None)
        start_j = np.asarray(kj._initialize_cluster_centers(htj.array(x, split=0)))
        cj = kj.fit(htj.array(x, split=0)).cluster_centers_.numpy()
    kt = htt.cluster.KMeans(k, init=init, random_state=random_state, max_iter=10, tol=None)
    start_t = kt._initialize_cluster_centers(htt.array(x, split=0)).numpy()
    ct = kt.fit(htt.array(x, split=0)).cluster_centers_.numpy()
    np.testing.assert_array_equal(start_t, start_j)
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-5)


def test_kmeans_default_init_is_heat_tpus(cpu):
    """``KMeans(8, random_state=0).fit(x)`` with every other argument left
    at its default: heat_tpu's labels and centres."""
    x = _blobs(3, 2000, 6, 8)
    with comm_context(SELF):
        kj = htj.cluster.KMeans(8, random_state=0).fit(htj.array(x, split=0))
    kt = htt.cluster.KMeans(8, random_state=0).fit(htt.array(x, split=0))
    np.testing.assert_array_equal(kt.labels_.numpy(), kj.labels_.numpy())
    np.testing.assert_allclose(kt.cluster_centers_.numpy(), kj.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)
