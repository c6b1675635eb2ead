"""heat_tpu_torch.frame and stream.StreamingGroupBy against heat_tpu's, on
the CPU: every verb of ``Frame`` (groupby/agg in every spec form, range and
hash mode, ``value_counts``, inner and left ``join``, ``filter``, the grouped
``quantile``), ``SHUFFLE_STATS``/``MOVE_STATS`` deltas, the grouped KLL
sketch, ``StreamingGroupBy`` and ``convert``'s two converters.

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does, on the same numpy inputs from seeds. There one rank holds every group
in key order, so heat_tpu's range and hash modes give one result: the
port's two modes meet one heat_tpu reference, made once per process (the
modes' layouts across ranks are held in ``tests/test_torch_dist.py``). Keys are int32, int64, float32,
float64 and bool; the float keys hold -0.0, 0.0 and NaNs (every NaN is a
group of its own; a ±0 group's key is its last row's).

Tolerances: keys, counts, integer sums, min, max, layouts and dtypes exact;
float sums, means and stds rtol 1e-5 / atol 1e-6 (float32 sums of at most
a few hundred values of order 1, each run summed in order on both sides,
and the std's difference of two such sums); the grouped KLL states and the
quantiles exact (both packages compress with the same arithmetic in the
same order).
"""
import numpy as np
import pytest

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt

RTOL, ATOL = 1e-5, 1e-6
_rng = np.random.default_rng(2028)
N = 240


def _keys(kind, rng, n=N):
    if kind == "bool":
        return rng.integers(0, 2, size=n).astype(bool)
    if kind in ("int32", "int64"):
        return rng.integers(-10, 10, size=n).astype(kind)
    k = rng.integers(-6, 6, size=n).astype(kind)
    k[::17] = -0.0
    k[5::23] = 0.0
    k[7::31] = np.nan
    return k


KEY_KINDS = ("int32", "int64", "float32", "float64", "bool")
KEYS = {kind: _keys(kind, np.random.default_rng(i)) for i, kind in enumerate(KEY_KINDS)}
VALS = {
    "x": _rng.normal(size=N).astype(np.float32),
    "y": (_rng.normal(size=N) * 3).astype(np.float64),
    "i": _rng.integers(-1000, 1000, size=N).astype(np.int32),
    "b": _rng.integers(0, 2, size=N).astype(bool),
}


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)


def _frames(cols):
    return htt.Frame(dict(cols)), htj.Frame(dict(cols))


class _Col:
    """A heat_tpu column as it stood when made (its ``numpy()`` rebalances it)."""

    def __init__(self, c):
        self.dtype, self.gshape, self.split, self.lcounts = c.dtype, tuple(c.gshape), c.split, c.lcounts
        self.lshape_map = np.asarray(c.lshape_map)
        self._values = np.asarray(c.numpy())

    def numpy(self):
        return self._values


class _Frozen:
    def __init__(self, frame):
        self.columns = frame.columns
        self._cols = {n: _Col(frame[n]) for n in self.columns}

    def __getitem__(self, name):
        return self._cols[name]


_REFS = {}


def _ref(key, make):
    """heat_tpu's frame ``make()``, made once per process under ``key``."""
    if key not in _REFS:
        _REFS[key] = _Frozen(make())
    return _REFS[key]


def _same_col(t, j, what):
    assert t.dtype.__name__ == j.dtype.__name__, (what, t.dtype, j.dtype)
    assert tuple(t.gshape) == tuple(j.gshape) and t.split == j.split, what
    assert t.lcounts == j.lcounts, (what, t.lcounts, j.lcounts)
    np.testing.assert_array_equal(t.lshape_map, np.asarray(j.lshape_map), err_msg=what)
    got, want = t.numpy(), np.asarray(j.numpy())
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
        np.testing.assert_array_equal(np.signbit(got[got == 0]), np.signbit(want[want == 0]), err_msg=what)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=what)


def _same(tf, jf, what=""):
    assert tf.columns == jf.columns, (tf.columns, jf.columns)
    for name in tf.columns:
        _same_col(tf[name], jf[name], f"{what}:{name}")


# ------------------------------------------------------------------- groupby
@pytest.mark.parametrize("mode", ["range", "hash"])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_groupby_every_agg_matches_heat_tpu(kind, mode):
    cols = {"k": KEYS[kind], **VALS}
    spec = ["sum", "mean", "min", "max", "count", "std"]
    want = _ref(("agg", kind), lambda: htj.Frame(cols).groupby("k").agg(spec))
    _same(htt.Frame(cols).groupby("k", mode=mode).agg(spec), want, f"{kind}/{mode}")


@pytest.mark.parametrize("spec", [
    "sum", ["mean", "std"], {"x": "max"}, {"x": ["min", "mean"], "i": "sum", "b": ["sum", "mean"]},
    {"y": ["std", "count", "sum"]}, ["count"],
])
def test_agg_spec_forms_and_column_names(spec):
    tf, jf = _frames({"k": KEYS["int32"], **VALS})
    _same(tf.groupby("k").agg(spec), jf.groupby("k").agg(spec), str(spec))


@pytest.mark.parametrize("ddof", [0, 1, 2])
def test_std_ddof_and_conveniences(ddof):
    tf, jf = _frames({"k": KEYS["int64"], "x": VALS["x"], "i": VALS["i"]})
    _same(tf.groupby("k").std(ddof=ddof), jf.groupby("k").std(ddof=ddof), f"std{ddof}")
    name = ("sum", "mean", "min", "max", "count")[ddof::3]  # the conveniences, spread over the cases
    for n in name:
        _same(getattr(tf.groupby("k"), n)(), getattr(jf.groupby("k"), n)(), n)


def test_signed_zero_and_nan_keys_pin_each_groups_key():
    """-0.0 and 0.0 are one group whose key is its last row's; every NaN is
    its own group, after every number."""
    for k in ([0.0, -0.0, np.nan, 1.0, -0.0, np.nan, 2.0, 0.0, -0.0], [-0.0, 0.0, 1.0], [0.0, -0.0, 1.0],
              [-0.0, -0.0, np.nan]):
        k = np.asarray(k, np.float32)
        cols = {"k": k, "v": np.arange(k.size, dtype=np.float32)}
        tf, jf = _frames(cols)
        want = _Frozen(jf.groupby("k").agg(["sum", "count"]))
        for mode in ("range", "hash"):
            _same(tf.groupby("k", mode=mode).agg(["sum", "count"]), want, f"{k}/{mode}")
    got = htt.Frame({"k": np.asarray([0.0, -0.0, 1.0], np.float32), "v": np.ones(3, np.float32)}).groupby("k").sum()
    assert np.signbit(got["k"].numpy()).tolist() == [True, False]


def test_value_counts_and_int_sums_wrap():
    q = np.random.default_rng(3).integers(1, 51, size=N).astype(np.int32)
    tf, jf = _frames({"q": q, "big": np.full(N, 2**30, np.int32)})
    want = _Frozen(jf.value_counts("q"))
    for mode in ("range", "hash"):
        _same(tf.value_counts("q", mode=mode), want, mode)
    _same(tf.groupby("q").sum(), jf.groupby("q").sum(), "wrap")


def test_errors_match_heat_tpu():
    tf, jf = _frames({"k": KEYS["int32"], "x": VALS["x"]})
    for call in (lambda f: f.groupby("nope"), lambda f: f.groupby("k").agg("median"),
                 lambda f: f.groupby("k").agg({"k": "sum"}), lambda f: f.groupby("k", mode="x").sum(),
                 lambda f: f.groupby("k").agg([]), lambda f: f.groupby("k").quantile(2.0)):
        with pytest.raises(Exception) as et:
            call(tf)
        with pytest.raises(Exception) as ej:
            call(jf)
        assert type(et.value).__name__ == type(ej.value).__name__
    for bad in ({}, {"a": np.zeros((2, 2))}, {"a": np.zeros(3), "b": np.zeros(4)}):
        with pytest.raises(ValueError):
            htt.Frame(bad)


def test_shuffle_and_move_stats_deltas_match_heat_tpu():
    deltas = []
    for ht, mv in ((htt, htt.MOVE_STATS), (htj, htj.parallel.flatmove.MOVE_STATS)):
        f = ht.Frame({"k": KEYS["int32"], **VALS})
        s0, m0 = dict(ht.SHUFFLE_STATS), dict(mv)
        f.groupby("k").agg(["mean", "std", "min"])
        f.value_counts("k", mode="hash")
        f.filter(f["x"] > 0)
        f.join(f.groupby("k").count(), on="k")
        deltas.append(({k: ht.SHUFFLE_STATS[k] - s0[k] for k in s0}, {k: mv[k] - m0[k] for k in m0}))
    assert deltas[0] == deltas[1]
    assert deltas[0][0] == {"groupbys": 3, "joins": 1, "compactions": 1}


# ------------------------------------------------------------ join, filter
@pytest.mark.parametrize("mode,kind,how", [(m, k, h) for k in ("int32", "float64") for h in ("inner", "left")
                                            for m in ("range", "hash")])
def test_join_matches_heat_tpu(how, kind, mode):
    rng = np.random.default_rng(11)
    lk = rng.integers(0, 60, size=N).astype(kind)
    rk = rng.permutation(80)[:50].astype(kind)
    left = {"k": lk, "x": VALS["x"], "i": VALS["i"]}
    right = {"k": rk, "x": rng.normal(size=rk.size).astype(np.float32),
             "r": rng.integers(0, 9, size=rk.size).astype(np.int32)}
    want = _ref(("join", how, kind), lambda: htj.Frame(left).join(htj.Frame(right), on="k", how=how))
    _same(htt.Frame(left).join(htt.Frame(right), on="k", how=how, mode=mode), want, f"{how}/{kind}/{mode}")


def test_join_errors_match_heat_tpu():
    tl, jl = _frames({"k": np.arange(6, dtype=np.int32), "a": np.arange(6.0)})
    tr, jr = _frames({"k": np.asarray([1, 1, 2], np.int32), "b": np.arange(3.0)})
    for a, b in ((tl, tr), (jl, jr)):
        with pytest.raises(ValueError, match="unique keys"):
            a.join(b, on="k")
        with pytest.raises(KeyError):
            a.join(b, on="z")
        with pytest.raises(ValueError):
            a.join(b, on="k", how="outer")
    t64, j64 = _frames({"k": np.arange(3, dtype=np.int64)})
    for a, b in ((tl, t64), (jl, j64)):
        with pytest.raises(TypeError):
            a.join(b, on="k")


def test_filter_matches_heat_tpu_and_chains():
    tf, jf = _frames({"k": KEYS["float32"], **VALS})
    tsub, jsub = tf.filter(tf["x"] > 0.2), jf.filter(jf["x"] > 0.2)
    _same(tsub, jsub, "filter")
    _same(tsub.groupby("k").agg(["sum", "count"]), jsub.groupby("k").agg(["sum", "count"]), "filter>groupby")
    mask = VALS["b"]
    _same(tf.filter(mask), jf.filter(mask), "numpy mask")
    with pytest.raises(TypeError):
        tf.filter(VALS["i"])
    with pytest.raises(ValueError):
        tf.filter(mask[:5])
    assert tsub.n_rows == len(tsub) == int((VALS["x"] > 0.2).sum()) and "x" in tsub and repr(tsub).startswith("Frame(")


# ------------------------------------------------------------------ quantile
@pytest.mark.parametrize("kind", ["int32", "float64", "bool"])
def test_grouped_quantile_matches_heat_tpu(kind):
    keys = KEYS[kind].copy()
    if keys.dtype.kind == "f":
        keys[np.isnan(keys)] = 7.0  # np.unique's one NaN group: the union of both packages is host numpy's
        keys[keys == 0] = 0.0
    tf, jf = _frames({"k": keys, "x": VALS["x"], "i": VALS["i"]})
    for q in (0.0, 0.3, 0.5, 1.0):
        _same(tf.groupby("k").quantile(q, k=16, levels=4), jf.groupby("k").quantile(q, k=16, levels=4), f"q{q}")


def test_grouped_kll_fold_merge_and_quantile_match_heat_tpu_exactly():
    import jax
    import jax.numpy as jnp

    from heat_tpu.stream.sketch import kll as jk
    from heat_tpu_torch.stream.sketch import kll as tk
    import torch

    rng = np.random.default_rng(5)
    G, L, k, H = 5, 120, 8, 3
    n = rng.integers(0, L, size=G).astype(np.int32)
    n[0], n[1] = 0, L
    v0, w0 = np.full((G, H, k), np.inf, np.float32), np.zeros((G, H, k), np.float32)
    states = []
    for seed in (1, 2):
        x = np.random.default_rng(seed).normal(size=(G, L, 1)).astype(np.float32)
        jv, jw = jk._grouped_fold_program(k, H)(jnp.asarray(x), jnp.asarray(n), jnp.asarray(v0), jnp.asarray(w0))
        tv, tw = tk._grouped_fold(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(v0),
                                  torch.from_numpy(w0))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        states.append(((jnp.asarray(n), jnp.ones(G, jnp.int32), jv, jw),
                       (torch.from_numpy(n), torch.ones(G, dtype=torch.int32), tv, tw)))
    jm = jax.jit(jk.grouped_merge_states)(states[0][0], states[1][0])
    tm = tk.grouped_merge_states(states[0][1], states[1][1])
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    qs = np.asarray([0.0, 0.1, 0.5, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(tk._grouped_quantile(tm[2], tm[3], torch.from_numpy(qs)).numpy(),
                                  np.asarray(jk._grouped_quantile(jm[2], jm[3], jnp.asarray(qs))))


# -------------------------------------------------------- StreamingGroupBy
AGG_SETS = [("count",), ("mean", "std"), ("sum", "mean", "min", "max", "count", "std")]


def _fold(ht, aggs, keys, vals, chunk, capacity=64):
    sg = ht.stream.StreamingGroupBy(aggs, capacity=capacity)
    for lo in range(0, keys.size, chunk):
        k = ht.array(keys[lo : lo + chunk], split=0)
        v = None if aggs == ("count",) else ht.array(vals[lo : lo + chunk], split=0)
        sg.update(k, v)
    return sg


def _same_result(t, j, what):
    assert list(t) == list(j), what
    for name in t:
        assert t[name].split is None and j[name].split is None
        _same_col(t[name], j[name], f"{what}:{name}")


@pytest.mark.parametrize("aggs", AGG_SETS)
@pytest.mark.parametrize("kind", ["int32", "float32", "bool"])
def test_streaming_groupby_matches_heat_tpu(aggs, kind):
    keys, vals = KEYS[kind], VALS["x"] if kind != "bool" else VALS["i"]
    t, j = _fold(htt, aggs, keys, vals, 50), _fold(htj, aggs, keys, vals, 50)
    assert t.n == j.n == N
    _same_result(t.result(), j.result(), f"{aggs}/{kind}")


def test_streaming_groupby_merge_and_frame_agree():
    keys, vals = KEYS["int64"], VALS["y"]
    for ht in (htt, htj):
        a = _fold(ht, ("sum", "mean", "std", "count", "min", "max"), keys[:100], vals[:100], 40)
        b = _fold(ht, ("sum", "mean", "std", "count", "min", "max"), keys[100:], vals[100:], 40)
        res = a.merge(b).result()
        assert a.n == N
        g = ht.Frame({"k": keys, "v": vals}).groupby("k").agg(["sum", "mean", "std", "count", "min", "max"])
        np.testing.assert_array_equal(res["key"].numpy(), g["k"].numpy())
        np.testing.assert_array_equal(res["count"].numpy(), g["count"].numpy())
        for name in ("sum", "mean", "std", "min", "max"):
            np.testing.assert_allclose(res[name].numpy(), g[f"v_{name}"].numpy(), rtol=RTOL, atol=ATOL)
    _same_result(_fold(htt, ("sum",), keys, vals, 30).merge(_fold(htt, ("sum",), keys, vals, 70)).result(),
                 _fold(htj, ("sum",), keys, vals, 30).merge(_fold(htj, ("sum",), keys, vals, 70)).result(), "merge")


def test_streaming_groupby_overflow_and_errors_match_heat_tpu():
    keys, vals = KEYS["int32"], VALS["x"]
    for ht in (htt, htj):
        sg = _fold(ht, ("sum",), keys, vals, 60, capacity=10)
        with pytest.raises(RuntimeError, match="exceeded capacity=10"):
            sg.result()
        with pytest.raises(RuntimeError, match="no chunks"):
            ht.stream.StreamingGroupBy().result()
        with pytest.raises(ValueError):
            ht.stream.StreamingGroupBy(("median",))
        with pytest.raises(ValueError):
            ht.stream.StreamingGroupBy(capacity=0)
        with pytest.raises(ValueError):
            ht.stream.StreamingGroupBy(("sum",)).update(ht.array(keys, split=0))
        with pytest.raises(ValueError):
            _fold(ht, ("sum",), keys, vals, 60, capacity=64).merge(ht.stream.StreamingGroupBy(("sum",), 32))
    exact = _fold(htt, ("count",), keys, vals, 60, capacity=int(np.unique(keys).size))
    assert exact.result()["count"].numpy().sum() == N


# ------------------------------------------------------------------ convert
def test_frame_converter_keeps_heat_tpus_layout():
    jf = htj.Frame({"k": KEYS["int32"], **VALS})
    jg = jf.filter(jf["x"] > 0)
    tg = htt.convert.frame_from_heat_tpu(jg.to_dict(), jg["k"].lcounts)
    _same(tg, jg, "filtered")
    tf = htt.convert.frame_from_heat_tpu(jf.to_dict())
    _same(tf.groupby("k").agg(["sum", "std"]), jf.groupby("k").agg(["sum", "std"]), "converted")
    with pytest.raises(ValueError):
        htt.convert.frame_from_heat_tpu(jg.to_dict(), (1, 2))


def test_streaming_groupby_converter_finishes_a_fold_begun_in_heat_tpu():
    aggs = ("sum", "mean", "std", "count", "min", "max")
    keys, vals = KEYS["float64"], VALS["y"]
    j = _fold(htj, aggs, keys[:130], vals[:130], 50)
    state = {"aggs": j.aggs, "capacity": j.capacity, "n": j.n, "keys": np.asarray(j._keys), "g": int(j._g),
             "overflow": bool(j._ov), "stats": [np.asarray(s) for s in j._stats],
             "value_dtype": np.dtype(j._vdtype).name}
    t = htt.convert.streaming_groupby_from_heat_tpu(state)
    for lo in range(130, N, 50):
        for ht, sg in ((htt, t), (htj, j)):
            sg.update(ht.array(keys[lo : lo + 50], split=0), ht.array(vals[lo : lo + 50], split=0))
    assert t.n == j.n == N
    _same_result(t.result(), j.result(), "carried")
