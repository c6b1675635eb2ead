"""The cases of tests/test_torch_dist.py, and the worker that runs them in
one rank of a ``torch.distributed`` group.

A case is a function of the package module ``ht`` that returns
``{name: value}`` (DNDarrays, tuples of them, python scalars, numpy
arrays, or :class:`Raised` for a call that raised). Names starting with
``world:`` hold values that depend on the world size (``lshape_map``
lists), ``meta:`` arrays whose values are undefined (``empty``), and
``port:`` facts of the port alone (``port:rank:`` ones that differ by
rank). The same code drives
``heat_tpu_torch`` in every rank of the group and ``heat_tpu`` on a
device mesh of the same size in the test process, on the same numpy
inputs made from seeds. :func:`pack` turns a result into plain values
(numpy arrays and metadata; for the port also this rank's ``larray``), so
the test process can hold the two against each other.

Run as a script, one process per rank:

    python tests/test_torch_dist_worker.py --rank R --world P --store FILE --out DIR [--backend gloo|nccl]

Each rank starts the group through ``ht.init_distributed`` (gloo on the
CPU, or NCCL on card R), runs every case and writes ``DIR/rank{R}.pkl``.
This module imports torch and heat_tpu_torch only — never JAX or
heat_tpu — and has no test functions.
"""
import argparse
import os
import pickle
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Raised:
    """A call that raised: the exception's type name and message."""

    def __init__(self, exc: BaseException):
        self.type = type(exc).__name__
        self.message = str(exc)


def attempt(fn):
    try:
        return fn()
    except Exception as e:  # the test compares which exception each package raised
        return Raised(e)


def is_port(ht) -> bool:
    return ht.__name__ == "heat_tpu_torch"


def pack(v, port: bool):
    """A case result as plain, picklable values. The layout is read before
    the values: heat_tpu's ``numpy()`` rebalances a ragged array, the port's
    gathers it as it lies; the port's ``local`` is this rank's rows as they
    lie (``_raw``)."""
    if hasattr(v, "gshape") and hasattr(v, "lshape_map"):
        lshape_map, lcounts = np.asarray(v.lshape_map), v.lcounts
        glob = np.asarray(v.numpy())
        out = {
            "kind": "array",
            # numpy has no bfloat16: heat_tpu's ml_dtypes array widened to float32, as the port's numpy() gives it
            "global": glob.astype(np.float32) if glob.dtype.name == "bfloat16" else glob,
            "dtype": v.dtype.__name__,
            "gshape": tuple(int(s) for s in v.gshape),
            "split": v.split,
            "lshape_map": lshape_map,
            "lcounts": None if lcounts is None else tuple(int(c) for c in lcounts),
        }
        if port:
            local = v._raw.detach().cpu()
            out["local"] = (local.float() if str(local.dtype) == "torch.bfloat16" else local).numpy()
        return out
    if isinstance(v, Raised):
        return {"kind": "raises", "type": v.type, "message": v.message}
    if isinstance(v, (tuple, list)):
        return {"kind": "seq", "items": [pack(i, port) for i in v]}
    if isinstance(v, np.ndarray):
        return {"kind": "ndarray", "value": v}
    if isinstance(v, (bool, int, float, np.generic)):
        return {"kind": "scalar", "value": v.item() if isinstance(v, np.generic) else v}
    if v is None or isinstance(v, (str, dict, bytes)):
        return {"kind": "plain", "value": v}
    raise TypeError(f"cannot pack a {type(v)}")


# ------------------------------------------------------------------ data
def _rng(seed):
    return np.random.default_rng(seed)


A93 = _rng(1).normal(size=(9, 3)).astype(np.float32)
A33 = _rng(2).normal(size=(3, 3)).astype(np.float32)
A95 = (_rng(3).normal(size=(9, 5)) * 2).astype(np.float32)
POS95 = _rng(4).uniform(0.1, 3.0, size=(9, 5)).astype(np.float32)
I95 = _rng(5).integers(-6, 7, size=(9, 5)).astype(np.int32)
NAN95 = A95.copy()
NAN95[2, 1] = NAN95[7, 4] = NAN95[0, 0] = np.nan
NAN95[:, 3] = np.nan
TIES95 = np.round(A95).astype(np.float32)  # many equal values: arg* must take the lowest index
V9 = _rng(6).normal(size=9).astype(np.float32)
V5 = _rng(7).normal(size=5).astype(np.float32)


def _blobs(seed, n, f, k, scale=10.0):
    rng = _rng(seed)
    centers = (rng.normal(size=(k, f)) * scale).astype(np.float32)
    member = rng.integers(0, k, size=n)
    member[:k] = np.arange(k)
    return (centers[member] + rng.normal(size=(n, f))).astype(np.float32), member


BLOBS, _ = _blobs(8, 203, 5, 3)
BLOBS_NEW, _ = _blobs(9, 37, 5, 3)
TALL = _rng(10).normal(size=(256, 8)).astype(np.float32)
RAGGED = _rng(11).normal(size=(20, 8)).astype(np.float32)

# names the unary/binary sweeps call, with the domain each takes
UNARY = {
    "exp": A95, "expm1": A95, "exp2": A95, "log": POS95, "log2": POS95, "log10": POS95, "log1p": POS95,
    "sqrt": POS95, "rsqrt": POS95, "square": A95, "cbrt": A95, "acos": A95 / 7, "arccos": A95 / 7,
    "acosh": POS95 + 1, "arccosh": POS95 + 1, "asin": A95 / 7, "arcsin": A95 / 7, "asinh": A95, "arcsinh": A95,
    "atan": A95, "arctan": A95, "atanh": A95 / 7, "arctanh": A95 / 7, "cos": A95, "cosh": A95, "deg2rad": A95,
    "radians": A95, "rad2deg": A95, "degrees": A95, "sin": A95, "sinc": A95, "sinh": A95, "tan": A95 / 7,
    "tanh": A95, "abs": A95, "absolute": A95, "ceil": A95, "floor": A95, "trunc": A95, "fabs": A95,
    "round": A95, "sign": A95, "sgn": A95, "nan_to_num": NAN95, "isfinite": NAN95, "isinf": NAN95,
    "isnan": NAN95, "isneginf": NAN95, "isposinf": NAN95, "signbit": A95, "logical_not": A95, "neg": A95,
    "negative": A95, "pos": A95, "positive": A95, "copy": A95,
}
BINARY = [
    "add", "sub", "subtract", "mul", "multiply", "div", "divide", "floordiv", "floor_divide", "mod", "remainder",
    "fmod", "pow", "power", "hypot", "copysign", "logaddexp", "logaddexp2", "atan2", "arctan2", "maximum",
    "minimum", "eq", "equal", "ne", "not_equal", "lt", "less", "le", "less_equal", "gt", "greater", "ge",
    "greater_equal", "isclose", "allclose", "logical_and", "logical_or", "logical_xor",
]
INT_BINARY = ["bitwise_and", "bitwise_or", "bitwise_xor", "left_shift", "right_shift"]
REDUCTIONS = ["sum", "prod", "nansum", "nanprod", "min", "max", "nanmin", "nanmax", "all", "any"]


# ----------------------------------------------------------------- cases
def case_layout(ht):
    a, b, c = ht.array(A93, split=0), ht.array(A33, split=0), ht.array(A95, split=1)
    d = ht.array(A93, split=0)
    d.resplit_(1)
    return {
        "a93_s0": a, "a33_s0": b, "a95_s1": c, "a93_s0_to_1": a.resplit(1), "a95_s1_to_0": c.resplit(0),
        "a93_s0_to_none": a.resplit(None), "a93_none_to_0": ht.array(A93).resplit(0), "resplit_": d,
        "a33_s0_to_1_to_none": b.resplit(1).resplit(None), "balanced": a.is_balanced(), "balance_": a.balance_(),
        "world:a95_s1_lshape": tuple(c.lshape_map[:, 1].tolist()),
    }


def case_factories(ht):
    x = ht.array(A95, split=1)
    return {
        "zeros": ht.zeros((9, 3), split=0), "ones": ht.ones((5, 7), split=1, dtype=ht.int32),
        "full": ht.full((9,), 2.5, split=0), "eye": ht.eye(7, split=0), "eye_rect": ht.eye((5, 9), split=1),
        "arange": ht.arange(10, split=0), "arange_step": ht.arange(1, 20, 3, split=0),
        "arange_float": ht.arange(0.0, 2.0, 0.25, split=0), "zeros_like": ht.zeros_like(x),
        "ones_like": ht.ones_like(x, split=0), "full_like": ht.full_like(x, 7), "array_ndmin": ht.array(V5, ndmin=2, split=1),
        "array_of_dndarray": ht.array(x, split=0), "array_int": ht.array(I95, split=0),
        "meta:empty": ht.empty((9, 3), split=0), "meta:empty_like": ht.empty_like(x),
    }


def case_is_split(ht):
    """Ranks hold 4, 0, 1 and the rest of 9 rows: the global array is their
    concatenation in rank order, rebalanced (heat_tpu, one controller, is
    handed the concatenation)."""
    if is_port(ht):
        comm = ht.get_comm()
        bounds = [0, 4, 4, 5] + [9] * comm.size
        r = comm.rank
        lo, hi = (bounds[r], bounds[r + 1]) if r < comm.size - 1 else (bounds[r], 9)
        shard, shard1 = A93[lo:hi], A95.T[:, lo:hi]
    else:
        shard, shard1 = A93, A95.T
    return {"rows": ht.array(shard, is_split=0), "cols": ht.array(shard1, is_split=1)}


def case_binary(ht):
    x0, x1, xn = ht.array(A95, split=0), ht.array(A95, split=1), ht.array(A95)
    p0 = ht.array(POS95, split=0)
    return {
        "s0+s0": x0 + p0, "s0*none": x0 * xn, "s0-row": x0 - ht.array(V5), "s1+row": x1 + ht.array(V5),
        "s0/col": x0 / ht.array(V9.reshape(9, 1)), "col_s0+none": ht.array(V9.reshape(9, 1), split=0) + xn,
        "row_s0+none": ht.array(V5.reshape(1, 5), split=0) + xn, "vec_s0+none": ht.array(V5, split=0) + xn,
        "scalar": 2.5 * x1 - 1, "rpow": 2 ** x0, "pow": p0 ** 0.5, "none+s1": xn + x1,
        "mismatch": attempt(lambda: x0 + x1), "out": ht.add(x0, 1.0, out=ht.zeros((9, 5), split=0)),
        "where_kw": ht.add(x0, p0, where=ht.array(A95 > 0, split=0)),
        "iadd": _iadd(ht), "cmp": x1 > xn,
    }


def _iadd(ht):
    y = ht.array(A95, split=0)
    y += 1
    return y


def case_unary_sweep(ht):
    out = {}
    for name, data in UNARY.items():
        for split in (0, 1):
            out[f"{name}:{split}"] = getattr(ht, name)(ht.array(data, split=split))
    out["clip"] = ht.clip(ht.array(A95, split=0), -1.0, 1.5)
    out["clip_arr"] = ht.clip(ht.array(A95, split=1), ht.array(-POS95, split=1), 2.0)
    out["modf"] = ht.modf(ht.array(A95, split=1))
    out["round2"] = ht.round(ht.array(A95, split=0), 2)
    out["invert"] = ht.invert(ht.array(I95, split=0))
    out["bitwise_not"] = ht.bitwise_not(ht.array(I95, split=1))
    out["astype"] = ht.array(A95, split=1).astype(ht.int32)
    out["transpose"] = ht.transpose(ht.array(A95, split=0))
    out["T"] = ht.array(A95, split=1).T
    return out


def case_binary_sweep(ht):
    out = {}
    for name in BINARY:
        a = ht.array(POS95 if name in ("pow", "power") else A95, split=0)
        b = ht.array(POS95, split=0) if name not in ("pow", "power") else ht.array(V5 / 3)
        out[name] = getattr(ht, name)(a, b)
    for name in INT_BINARY:
        b = np.abs(I95) % 4 if "shift" in name else I95[::-1].copy()
        out[name] = getattr(ht, name)(ht.array(I95, split=1), ht.array(b, split=1))
    out["equal_same"] = ht.equal(ht.array(A95, split=0), ht.array(A95))
    out["allclose_same"] = ht.allclose(ht.array(A95, split=0), ht.array(A95 + 1e-7))
    return out


def case_reductions(ht):
    out = {}
    for name in REDUCTIONS:
        for label, data, split in (("s0", A95, 0), ("s1", A95, 1), ("nan", NAN95, 0), ("e33", A33, 0)):
            x = ht.array(data if name not in ("all", "any") else data > 0.5, split=split)
            for axis in (None, 0, 1):
                out[f"{name}:{label}:{axis}"] = getattr(ht, name)(x, axis=axis)
            out[f"{name}:{label}:keep"] = getattr(ht, name)(x, axis=split, keepdims=True)
    out["sum_int"] = ht.sum(ht.array(I95, split=1), axis=1)
    out["method"] = ht.array(A95, split=0).sum(axis=0)
    return out


def case_arg(ht):
    out = {}
    for label, data in (("ties", TIES95), ("nan", NAN95), ("e33", A33)):
        for split in (0, 1):
            x = ht.array(data, split=split)
            for axis in (None, 0, 1):
                out[f"argmin:{label}:{split}:{axis}"] = ht.argmin(x, axis=axis)
                out[f"argmax:{label}:{split}:{axis}"] = ht.argmax(x, axis=axis)
    out["argmax_bool"] = ht.argmax(ht.array(A95 > 2, split=0), axis=0)
    return out


def case_cumulative(ht):
    out = {}
    for label, data, split in (("s0", A95 / 3, 0), ("s1", A95 / 3, 1), ("e33", A33, 0), ("int", I95, 0)):
        x = ht.array(data, split=split)
        for axis in (0, 1):
            out[f"cumsum:{label}:{axis}"] = ht.cumsum(x, axis)
            out[f"cumprod:{label}:{axis}"] = ht.cumprod(x, axis)
        out[f"cumproduct:{label}"] = ht.cumproduct(x, split)
    out["cumsum_bool"] = ht.cumsum(ht.array(A95 > 0, split=0), 0)
    out["diff0"] = ht.diff(ht.array(A95, split=0), axis=0)
    out["diff1"] = ht.diff(ht.array(A95, split=0), n=2, axis=1)
    out["diff_prepend"] = ht.diff(ht.array(A95, split=1), axis=1, prepend=0.0)
    return out


def case_moments(ht):
    out = {}
    for label, data, split in (("s0", A95, 0), ("s1", A95, 1), ("e33", A33, 0), ("f64", A95.astype(np.float64), 0),
                               ("vec", V9, 0), ("int", I95, 0)):
        x = ht.array(data, split=split)
        axes = (None, 0) if data.ndim == 1 else (None, 0, 1)
        for axis in axes:
            out[f"mean:{label}:{axis}"] = ht.mean(x, axis=axis)
            out[f"var:{label}:{axis}"] = ht.var(x, axis=axis)
            out[f"std:{label}:{axis}"] = ht.std(x, axis=axis, ddof=1)
    mask = ht.array(_rng(12).random((9, 5)) > 0.3, split=0)
    for axis in (None, 0, 1):
        out[f"mean_where:{axis}"] = ht.mean(ht.array(A95, split=0), axis=axis, where=mask)
    x = ht.array(A95, split=0)
    z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
    out["standardized"] = z
    return out


def case_indexing(ht):
    x0, x1 = ht.array(A95, split=0), ht.array(A95, split=1)
    out = {
        "int0": x0[2], "neg0": x0[-1], "slice0": x0[2:7], "step0": x0[1:8:3], "col0": x0[:, 1],
        "cols0": x0[:, 1:3], "tail0": x0[7:], "head0": x0[:3], "elem0": x0[5, 2], "ell0": x0[..., 4],
        "int1": x1[2], "slice1": x1[:, 1:4], "col1": x1[:, 3], "rows1": x1[3:6], "empty0": x0[4:4],
        "float": float(x0[3, 1]), "len": len(x1), "item": x1[8, 4].item(), "tolist": x1[1:3].tolist(),
        "iter": [float(v.sum()) for v in ht.array(A33, split=0)], "numpy": x1.numpy(),
        "bool": bool(x0[0, 0] > 0), "int": int(ht.array(I95, split=0)[4, 4]),
        "where": ht.where(x0 > 0, x0, 0.0), "where_s1": ht.where(x1 > 0, 1.0, x1),
        "where_mixed": ht.where(ht.array(A95 > 0, split=0), ht.array(A95), -1.0),
        "nonzero0": ht.nonzero(x0 > 1), "nonzero1": ht.nonzero(x1 > 1), "nonzero_vec": ht.nonzero(ht.array(V9, split=0) > 0),
        "oob": attempt(lambda: x0[9]),
    }
    return out


def case_linalg(ht):
    a0, a1, an = ht.array(A95, split=0), ht.array(A95, split=1), ht.array(A95)
    out = {}
    bt = _rng(13).normal(size=(5, 4)).astype(np.float32)
    for sa, a in (("0", a0), ("1", a1), ("n", an)):
        for sb in (0, 1, None):
            out[f"matmul:{sa}:{sb}"] = ht.matmul(a, ht.array(bt, split=sb))
    out["ata"] = a0.T @ a0
    out["aat"] = a1 @ a1.T
    out["matvec"] = a0 @ ht.array(V5)
    out["vecmat"] = ht.array(V9, split=0) @ an
    for sa, a in (("0", a0), ("1", a1), ("n", an)):
        out[f"matvec:{sa}:0"] = ht.matmul(a, ht.array(V5, split=0))
    for sv in (0, None):
        for sb, b in (("0", a0), ("1", a1)):
            out[f"vecmat:{sv}:{sb}"] = ht.matmul(ht.array(V9, split=sv), b)
    if is_port(ht):
        v0 = ht.array(V5, split=0)
        before = {k: dict(v) for k, v in ht.kernels.COLLECTIVES.items()}
        ht.matmul(a1, v0)  # lstsq's Q^T b across ranks: the contracted axis split on both sides
        out["port:matvec_collectives"] = {k: v["calls"] - before.get(k, {}).get("calls", 0)
                                          for k, v in ht.kernels.COLLECTIVES.items()
                                          if v["calls"] != before.get(k, {}).get("calls", 0)}
    out["dot_vec"] = ht.dot(ht.array(V9, split=0), ht.array(V9))
    out["dot_mat"] = ht.dot(a0, ht.array(bt))
    out["outer"] = ht.outer(ht.array(V9, split=0), ht.array(V5))
    out["outer_s1"] = ht.outer(ht.array(V9), ht.array(V5, split=0), split=1)
    sq = ht.array(_rng(14).normal(size=(7, 7)).astype(np.float32), split=0)
    out["trace"] = ht.trace(sq)
    out["trace_off"] = ht.linalg.trace(ht.array(A95, split=1), 1)
    for name in ("tril", "triu"):
        for k in (-1, 0, 2):
            out[f"{name}:0:{k}"] = getattr(ht, name)(a0, k)
            out[f"{name}:1:{k}"] = getattr(ht, name)(a1, k)
        out[f"{name}:vec"] = getattr(ht, name)(ht.array(V5, split=0))
    out["norm"] = ht.norm(a1)
    out["norm_ax"] = ht.norm(a0, axis=1)
    out["vector_norm0"] = ht.vector_norm(a0, axis=0, ord=1)
    out["vector_norm1"] = ht.vector_norm(a0, axis=1)
    out["vector_norm_all"] = ht.vector_norm(a1)
    out["matrix_norm"] = ht.matrix_norm(a0)
    out["matrix_norm_inf"] = ht.matrix_norm(a1, ord=np.inf)
    g = _rng(16).normal(size=(6, 6))
    spd = ht.array((g @ g.T / 6 + np.eye(6)).astype(np.float32))
    low = ht.linalg.cholesky(spd)
    out["cholesky_replicated"] = low
    out["solve_replicated"] = ht.linalg.solve_triangular(low, ht.array(V5[:5].repeat(2)[:6]), lower=True)
    return out


def _sign_fixed(q, r):
    """Q and R with R's diagonal made non-negative (QR is unique up to
    those signs)."""
    rn, qn = r.numpy(), None if q is None else q.numpy()
    s = np.where(np.diag(rn) < 0, -1.0, 1.0).astype(rn.dtype)
    return (None if qn is None else qn * s[None, : qn.shape[1]]), rn * s[: rn.shape[0], None]


def case_qr(ht):
    out = {}
    for label, data, split in (("tall", TALL, 0), ("ragged", RAGGED, 0), ("e93", A93, 0), ("s1", TALL[:40], 1),
                               ("none", RAGGED, None)):
        q, r = ht.linalg.qr(ht.array(data, split=split))
        out[f"world:{label}:meta_q"] = (q.gshape, q.split, q.lshape_map.tolist())
        out[f"world:{label}:meta_r"] = (r.gshape, r.split, r.lshape_map.tolist())
        out[f"{label}:qr"] = _sign_fixed(q, r)
        out[f"{label}:resid"] = float(np.abs(q.numpy() @ r.numpy() - data).max())
    out["r_only"] = _sign_fixed(None, ht.linalg.qr(ht.array(TALL, split=0), calc_q=False).R)[1]
    out["householder"] = _sign_fixed(*ht.linalg.qr(ht.array(TALL, split=0), method="householder"))
    # tiles_per_proc: the local level of the tree factors row tiles of each rank's 64 rows
    out["tiles2"] = _sign_fixed(*ht.linalg.qr(ht.array(TALL, split=0), tiles_per_proc=2))
    out["tiles3_r_only"] = _sign_fixed(None, ht.linalg.qr(ht.array(RAGGED, split=0), tiles_per_proc=3, calc_q=False).R)[1]
    return out


def case_kmeans(ht):
    x = ht.array(BLOBS, split=0)
    z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
    init = z[:3].resplit(None)
    out = {}
    if is_port(ht):
        ht.kernels.reset_kernel_stats()
    km = ht.cluster.KMeans(n_clusters=3, init=init, max_iter=5, tol=None).fit(z)
    if is_port(ht):
        out["port:collectives"] = {k: dict(v) for k, v in ht.kernels.COLLECTIVES.items()}
    out.update({
        "centers": km.cluster_centers_, "labels": km.labels_, "inertia": km.inertia_, "n_iter": km.n_iter_,
        "predict": km.predict(ht.array(BLOBS_NEW, split=0) - ht.mean(x, axis=0)),
        "predict_e33": km.predict(ht.array(BLOBS_NEW[:3], split=0)),
    })
    km_tol = ht.cluster.KMeans(n_clusters=3, init=z[:3], max_iter=50, tol=1e-4).fit(z)
    out.update({"tol_n_iter": km_tol.n_iter_, "tol_centers": km_tol.cluster_centers_, "tol_labels": km_tol.labels_})
    state = km.state_dict()
    back = ht.cluster.KMeans().load_state_dict(state)
    out.update({"state_labels": back.labels_, "state_centers": back.cluster_centers_,
                "state_keys": sorted(state)})
    for init_name in ("random", "kmeans++"):
        k2 = ht.cluster.KMeans(n_clusters=3, init=init_name, max_iter=3, tol=None, random_state=5)
        start = k2._initialize_cluster_centers(z)
        out[f"init0:{init_name}"] = start.cpu().numpy() if is_port(ht) else np.asarray(start)
        out[f"init:{init_name}"] = k2.fit(z).cluster_centers_
    return out


def case_knn(ht):
    rng = _rng(15)
    y = ht.array(BLOBS[:150], split=0)
    q0, qn = ht.array(BLOBS_NEW, split=0), ht.array(BLOBS_NEW)
    labels = ht.array((rng.integers(0, 3, size=150)).astype(np.int32), split=0)
    out = {
        "nn_s0": ht.spatial.nearest_neighbors(q0, ht.array(BLOBS[:150]), 4),
        "nn_ysplit": ht.spatial.nearest_neighbors(q0, y, 3),
        "nn_none": ht.spatial.nearest_neighbors(qn, y, 2),
        "nn_e33": ht.spatial.nearest_neighbors(ht.array(BLOBS_NEW[:3], split=0), y, 5),
    }
    clf = ht.classification.KNeighborsClassifier(n_neighbors=5).fit(y, labels)
    out["predict"] = clf.predict(q0)
    out["predict_none"] = clf.predict(qn)
    out["predict_e33"] = clf.predict(ht.array(BLOBS_NEW[:3], split=0))
    out["predict_s1"] = attempt(lambda: clf.predict(ht.array(BLOBS_NEW, split=1)))
    return out


def case_spatial(ht):
    x0, xn = ht.array(BLOBS[:30], split=0), ht.array(BLOBS[:30])
    yn, y0 = ht.array(BLOBS_NEW[:11]), ht.array(BLOBS_NEW[:11], split=0)
    out = {
        "cdist:0n": ht.spatial.cdist(x0, yn), "cdist:n0": ht.spatial.cdist(xn, y0),
        "cdist_quad": ht.spatial.cdist(x0, yn, quadratic_expansion=True), "cdist_self": ht.spatial.cdist(xn),
        "rbf:0n": ht.spatial.rbf(x0, yn, sigma=3.0), "rbf:n0": ht.spatial.rbf(xn, y0, sigma=3.0),
        "manhattan:0n": ht.spatial.manhattan(x0, yn), "manhattan:self": ht.spatial.manhattan(xn),
    }
    # two split operands: ragged chunks (8, 8, 8, 6 rows against 3, 3, 3, 2), and y with an empty last chunk
    y3 = ht.array(BLOBS_NEW[:3], split=0)
    for ring in (False, True):
        tag = "ring" if ring else "gather"
        out[f"cdist:00:{tag}"] = ht.spatial.cdist(x0, y0, use_ring=ring)
        out[f"cdist_quad:00:{tag}"] = ht.spatial.cdist(x0, y0, quadratic_expansion=True, use_ring=ring)
        out[f"rbf:00:{tag}"] = ht.spatial.rbf(x0, y0, sigma=3.0, use_ring=ring)
        out[f"manhattan:00:{tag}"] = ht.spatial.manhattan(x0, y0, use_ring=ring)
        out[f"cdist:self:{tag}"] = ht.spatial.cdist(x0, use_ring=ring)
        out[f"rbf:empty_chunk:{tag}"] = ht.spatial.rbf(x0, y3, sigma=2.0, use_ring=ring)
        out[f"manhattan:x_empty_chunk:{tag}"] = ht.spatial.manhattan(ht.array(BLOBS[:3], split=0), y3, use_ring=ring)
    return out


def _spd(seed, n):
    g = _rng(seed).normal(size=(n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def _triangular(seed, n, lower):
    t = _rng(seed).normal(size=(n, n)) / np.sqrt(n) + np.diag(2.0 + _rng(seed + 1).uniform(size=n))
    return (np.tril(t) if lower else np.triu(t)).astype(np.float32)


def case_factorizations(ht):
    """The distributed cholesky and solve_triangular: n = 13 and 10 leave
    the last rank short, n = 6 leaves it empty; tiles_per_proc 2 cuts the
    panels below the chunk length."""
    out = {}
    for n in (13, 10, 6):
        a = _spd(20 + n, n)
        for tpp in (1, 2):
            out[f"chol:{n}:0:{tpp}"] = ht.linalg.cholesky(ht.array(a, split=0), tiles_per_proc=tpp)
        out[f"chol:{n}:1"] = ht.linalg.cholesky(ht.array(a, split=1))
        out[f"chol:{n}:none"] = ht.linalg.cholesky(ht.array(a))
        out[f"world:edge:{n}:2"] = ht.factor_block_edge(ht.array(a, split=0), 2, -(-n // ht.get_comm().size))
    bad = _spd(40, 13)
    bad[7, 7] = -30.0  # not positive definite from the third panel of 2 rows on (tiles_per_proc 2)
    for tpp in (1, 2):
        out[f"chol_not_spd:0:{tpp}"] = ht.linalg.cholesky(ht.array(bad, split=0), tiles_per_proc=tpp)
    out["chol_not_spd:first_block"] = ht.linalg.cholesky(ht.array(np.array([[1, 2, 0], [2, 1, 0], [0, 0, 1]],
                                                                           np.float32), split=0))
    out["chol_int"] = ht.linalg.cholesky(ht.array(np.eye(5, dtype=np.int32) * 4, split=0))
    b = _rng(41).normal(size=(13, 3)).astype(np.float32)
    for lower in (True, False):
        t = _triangular(42, 13, lower)
        for unit in (False, True):
            tag = f"{'lower' if lower else 'upper'}:{int(unit)}"
            out[f"trsv:{tag}:vec0"] = ht.linalg.solve_triangular(ht.array(t, split=0), ht.array(b[:, 0], split=0),
                                                                 lower=lower, unit_diagonal=unit)
            out[f"trsm:{tag}:mat_none"] = ht.linalg.solve_triangular(ht.array(t, split=0), ht.array(b), lower=lower,
                                                                     unit_diagonal=unit)
        out[f"trsm:{'lower' if lower else 'upper'}:split1"] = ht.linalg.solve_triangular(
            ht.array(t, split=1), ht.array(b, split=0), lower=lower)
        out[f"trsv:{'lower' if lower else 'upper'}:vec_none"] = ht.linalg.solve_triangular(
            ht.array(t, split=0), ht.array(b[:, 1]), lower=lower)
    t6 = _triangular(43, 6, True)
    out["trsm:empty_chunk"] = ht.linalg.solve_triangular(ht.array(t6, split=0), ht.array(b[:6], split=0), lower=True)
    out["trsm:replicated_a"] = ht.linalg.solve_triangular(ht.array(t6), ht.array(b[:6], split=0), lower=True)
    # the kernel-ridge path on split operands: rbf -> + eye -> cholesky -> two triangular solves
    x = ht.array(BLOBS[:37], split=0)
    x = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
    K = ht.spatial.rbf(x, x, sigma=5 ** 0.5) + ht.eye(37, split=0)
    L = ht.linalg.cholesky(K, tiles_per_proc=2)
    yv = ht.array(V9.repeat(5)[:37], split=0)
    alpha = ht.linalg.solve_triangular(L.T, ht.linalg.solve_triangular(L, yv, lower=True), lower=False)
    out.update({"ridge:K": K, "ridge:L": L, "ridge:alpha": alpha})
    return out


def _general(seed, n):
    """A nonsymmetric matrix, diagonally weighted enough to be well conditioned."""
    return (_rng(seed).normal(size=(n, n)) + 3.0 * np.eye(n)).astype(np.float32)


def _odd_permutation(n):
    """P diag(1..n) with P swapping rows 0 and n - 1: det = -n!, reached by an odd number of row exchanges."""
    m = np.diag(np.arange(1.0, n + 1.0)).astype(np.float32)
    m[[0, n - 1]] = m[[n - 1, 0]]
    return m


def case_lu(ht):
    """solve, det and inv by the distributed LU: n = 13 leaves the last rank one row, n = 6 none."""
    out = {}
    b = _rng(50).normal(size=(13, 3)).astype(np.float32)
    for n in (13, 6):
        a = _general(51 + n, n)
        for sa in (0, 1, None):
            A = ht.array(a, split=sa)
            out[f"solve:{n}:{sa}:vec0"] = ht.linalg.solve(A, ht.array(b[:n, 0], split=0))
            out[f"solve:{n}:{sa}:mat_none"] = ht.linalg.solve(A, ht.array(b[:n]))
            out[f"det:{n}:{sa}"] = ht.det(A)
            out[f"inv:{n}:{sa}"] = ht.inv(A)
    out["solve:mat0"] = ht.linalg.solve(ht.array(_general(60, 13), split=0), ht.array(b, split=0))
    singular = _general(61, 13)
    singular[:, 5] = 0.0  # the sixth pivot is zero: its multipliers stay zero and det is an exact 0
    out["det:singular"] = ht.linalg.det(ht.array(singular, split=0))
    out["det:singular_s1"] = ht.det(ht.array(singular.T.copy(), split=1))
    out["det:odd_swaps"] = ht.linalg.det(ht.array(_odd_permutation(13), split=0))
    out["det:odd_swaps_s1"] = ht.det(ht.array(_odd_permutation(13), split=1))
    ties = np.array([[1, 2, 0, 1], [-1, 0, 2, 1], [1, -1, 1, 0], [0, 1, -1, 2]], np.int32)  # |column 0| ties
    out["det:int_ties"] = ht.det(ht.array(ties, split=0))
    out["inv:int_ties"] = ht.inv(ht.array(ties, split=0))
    out["det:f64"] = ht.det(ht.array(_general(62, 13).astype(np.float64), split=0))
    out["inv:f64"] = ht.inv(ht.array(_general(63, 13).astype(np.float64), split=1))
    stack = np.stack([_general(64 + i, 5) for i in range(5)])
    out["det:batch0"] = ht.det(ht.array(stack, split=0))
    out["inv:batch0"] = ht.inv(ht.array(stack, split=0))
    out["det:stack_split2"] = ht.det(ht.array(stack, split=2))
    out["inv:stack_split1"] = ht.inv(ht.array(stack, split=1))
    return out


def case_solver(ht):
    """cg (float64: it stops on r.r < 1e-20 well before n iterations) and lanczos on split and replicated operands."""
    g = _rng(70).normal(size=(30, 30))
    spd = g @ g.T / 30 + np.eye(30)
    bv = _rng(71).normal(size=30)
    out = {}
    for sa in (0, 1, None):
        A = ht.array(spd, split=sa)
        out[f"cg:{sa}"] = ht.linalg.cg(A, ht.array(bv, split=0), ht.array(np.zeros(30)))
        out[f"cg:{sa}:b_none"] = ht.linalg.cg(A, ht.array(bv), ht.array(bv / 2, split=0))
    sym = spd.astype(np.float32)
    for sa in (0, None):
        V, T = ht.linalg.lanczos(ht.array(sym, split=sa), 12)
        out[f"lanczos:{sa}"] = (V, T)
    out["lanczos:v0"] = ht.linalg.lanczos(ht.array(sym, split=0), 8, v0=ht.array(bv.astype(np.float32), split=0))
    return out


def _svd_signs(U, S, Vh):
    """U, S, Vh as numpy arrays with each singular pair's sign fixed: the largest |entry| of each Vh row positive."""
    u, s, vh = U.numpy(), S.numpy(), Vh.numpy()
    sg = np.sign(vh[np.arange(vh.shape[0]), np.abs(vh).argmax(axis=1)])
    return u * sg[None, :], s, vh * sg[:, None]


def case_svd(ht):
    rng = _rng(80)
    tall = rng.normal(size=(64, 8)).astype(np.float32)
    wide = rng.normal(size=(6, 20)).astype(np.float32)
    out = {}
    for label, data, sa in (("tall0", tall, 0), ("tall1", tall, 1), ("tallN", tall, None), ("wide0", wide, 0)):
        U, S, Vh = ht.linalg.svd(ht.array(data, split=sa))
        out[f"world:{label}:meta"] = [(x.gshape, x.split, x.lshape_map.tolist()) for x in (U, S, Vh)]
        out[f"{label}:usv"] = _svd_signs(U, S, Vh)
        out[f"{label}:svals"] = ht.linalg.svd(ht.array(data, split=sa), compute_uv=False)
        out[f"{label}:pinv"] = ht.linalg.pinv(ht.array(data, split=sa))
    rr = ht.linalg.rsvd(ht.array(tall, split=0), 3, n_oversamples=2, random_state=5)
    out["world:rsvd:meta"] = [(x.gshape, x.split, x.lshape_map.tolist()) for x in rr]
    out["rsvd:usv"] = _svd_signs(*rr)
    ht.random.seed(9)
    out["rsvd:stream"] = _svd_signs(*ht.linalg.rsvd(ht.array(tall, split=1), 4, n_iter=1))
    out["rsvd:state"] = ht.random.get_state()
    yv = rng.normal(size=64).astype(np.float32)
    ym = rng.normal(size=(64, 2)).astype(np.float32)
    out["lstsq:qr_vec"] = ht.linalg.lstsq(ht.array(tall, split=0), ht.array(yv, split=0))
    out["lstsq:qr_mat"] = ht.linalg.lstsq(ht.array(tall, split=0), ht.array(ym))
    deficient = tall.copy()
    deficient[:, 3] = deficient[:, 1]
    out["lstsq:pinv_route"] = ht.linalg.lstsq(ht.array(deficient, split=0), ht.array(yv, split=0))
    out["lstsq:rcond"] = ht.linalg.lstsq(ht.array(tall, split=0), ht.array(ym, split=0), rcond=1e-3)
    v9, w9 = ht.array(V9, split=0), ht.array(V9[::-1].copy())
    out["vdot"] = ht.vdot(v9, w9)
    out["vdot:int"] = ht.vdot(ht.array(I95, split=0), ht.array(I95, split=1))
    out["vecdot"] = ht.vecdot(ht.array(A95, split=0), ht.array(POS95, split=0))
    out["vecdot:axis0"] = ht.linalg.vecdot(ht.array(A95, split=1), ht.array(A95), axis=0, keepdims=True)
    out["vecdot:int"] = ht.vecdot(ht.array(I95, split=0), ht.array(I95))
    out["projection"] = ht.projection(v9, w9)
    a3, b3 = ht.array(A93, split=0), ht.array(A93[::-1].copy())
    out["cross"] = ht.cross(a3, b3)
    out["cross:axis0"] = ht.cross(ht.array(A93.T.copy(), split=1), ht.array(A93.T.copy()), axis=0)
    out["cross:2d"] = ht.cross(ht.array(A95[:, :2], split=0), ht.array(POS95[:, :2], split=0))
    out["cross:2x3"] = ht.linalg.cross(ht.array(A95[:, :2], split=0), a3)
    return out


def _spectral_blobs():
    """Three blobs of 40 rows in 3-D, far apart: label-exact spectral clustering."""
    x, member = _blobs(90, 120, 3, 3, scale=6.0)
    return x, member


def case_spectral(ht):
    x, _ = _spectral_blobs()
    X = ht.array(x, split=0)
    out = {}
    for definition in ("simple", "norm_sym"):
        for mode in ("fully_connected", "eNeighbour"):
            for key in ("upper", "lower"):
                lap = ht.graph.Laplacian(lambda z: ht.spatial.rbf(z, sigma=2.0), definition=definition, mode=mode,
                                         threshold_key=key, threshold_value=0.3, weighted=key == "upper")
                out[f"laplacian:{definition}:{mode}:{key}"] = lap.construct(X)
    out["laplacian:replicated"] = ht.graph.Laplacian(lambda z: ht.spatial.rbf(z, sigma=2.0)).construct(ht.array(x))
    sp = ht.cluster.Spectral(n_clusters=3, gamma=0.05, n_lanczos=30, random_state=4, max_iter=20)
    sp.fit(X)
    out["labels"] = sp.labels_
    out["predict"] = sp.predict(X)
    out["labels_none"] = ht.cluster.Spectral(n_clusters=3, gamma=0.05, n_lanczos=30, random_state=4).fit(
        ht.array(x)).labels_
    eigengap = ht.cluster.Spectral(gamma=0.05, n_lanczos=30, random_state=4)
    eigengap.fit(X)
    out["eigengap_k"] = eigengap.n_clusters
    return out


def case_convert(ht):
    state = {
        "n_clusters": 3, "max_iter": 7, "tol": None, "random_state": 1, "n_iter": 7, "inertia": 12.5,
        "cluster_centers": BLOBS[:3], "labels": (np.arange(203) % 3).astype(np.int64), "labels_split": 0,
    }
    if is_port(ht):
        km = ht.convert.from_heat_tpu_state(state)
        arr = ht.convert.array_from_numpy(A95, split=1)
        clf = ht.convert.knn_from_heat_tpu(BLOBS[:40], state["labels"][:40], n_neighbors=3, split=0)
    else:
        km = ht.cluster.KMeans().load_state_dict(state)
        arr = ht.array(A95, split=1)
        clf = ht.classification.KNeighborsClassifier(n_neighbors=3).fit(
            ht.array(BLOBS[:40], split=0), ht.array(state["labels"][:40], split=0))
    return {"labels": km.labels_, "centers": km.cluster_centers_, "array": arr,
            "knn_predict": clf.predict(ht.array(BLOBS_NEW, split=0))}


# names whose call above world size 1 raises NotImplementedError naming its ROADMAP item: none since the
# distributed cholesky/solve_triangular and cdist/rbf of two split operands; a slice that leaves one lists it
NOT_IMPLEMENTED = {}


def case_not_implemented(ht):
    return {name: attempt(lambda fn=fn: fn(ht)) for name, fn in NOT_IMPLEMENTED.items()}


def case_environment(ht):
    """Port-only facts of the rank: what it imported, and its group."""
    comm = ht.get_comm()
    x = ht.array(A93, split=0)
    before = {k: dict(v) for k, v in ht.kernels.COLLECTIVES.items()}
    decision = ht.replicated_decision(comm.rank == comm.size - 1)
    return {
        "leaked": ",".join(sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "jaxlib", "heat_tpu", "flax", "optax"))),
        "size": comm.size, "rank": comm.rank, "backend": comm.backend, "device": str(x.larray.device),
        "decision": decision, "collectives_before": before,
    }


def case_random(ht):
    """The draws at several seeds, counters, types and splits, (9, 5) split
    1 among them (a padded non-leading split on four ranks); for the port
    also the elements each draw computed on this rank."""
    fills = []
    if is_port(ht):
        from heat_tpu_torch.core import random as port_random

        real_fill = port_random._fill

        def counting_fill(key, layout, kind, *args):
            t = real_fill(key, layout, kind, *args)
            fills.append(t.numel())
            return t

        port_random._fill = counting_fill
    try:
        ht.random.seed(3)
        a = ht.random.randn(9, 5, split=0)
        ht.random.seed(3)
        b = ht.random.randn(9, 5, split=1)
        ht.random.seed(3)
        c = ht.random.randn(9, 5)
        out = {"randn:0": a, "randn:1": b, "randn:none": c}
        ht.random.seed(4)
        out.update({"rand:1": ht.random.rand(3, 10, split=1), "randint:0": ht.random.randint(0, 9, size=(11,), split=0),
                    "state": ht.random.get_state()})
        ht.random.set_state(("Threefry", 2**40 + 7, 0x7FFFFFF0))
        out.update({
            "rand64:1": ht.random.rand(9, 5, dtype=ht.float64, split=1), "rand:0_e33": ht.random.rand(3, 3, split=0),
            "randn64:0": ht.random.randn(7, 3, dtype=ht.float64, split=0),
            "randint64:1": ht.random.randint(-2**62, 2**62 + 12345, size=(3, 9), dtype=ht.int64, split=1),
            "random_integer": ht.random.random_integer(5, size=(9,), split=0),
            "uniform:1": ht.random.uniform(-2.0, 3.0, size=(9, 5), split=1),
            "normal:0": ht.random.normal(1.5, 0.25, shape=(9, 5), split=0),
            "standard_normal": ht.random.standard_normal((4, 9), split=1),
            "random_sample": ht.random.random_sample((9, 2), split=0), "ranf": ht.random.ranf((5,)),
            "sample": ht.random.sample((2, 9), split=1), "scalar": ht.random.rand(),
            "randperm:0": ht.random.randperm(11, split=0), "randperm": ht.random.randperm(300),
            "permutation:int": ht.random.permutation(9, split=0),
            "permutation:rows0": ht.random.permutation(ht.array(A95, split=0)),
            "permutation:rows1": ht.random.permutation(ht.array(A95, split=1)),
            "state_after": ht.random.get_state(),
        })
        big = ht.random.randn(1000, 7, split=0)
        out["big:0"] = big
    finally:
        if is_port(ht):
            port_random._fill = real_fill
    if is_port(ht):
        comm = ht.get_comm()
        out["port:fills"] = np.array(fills)
        out["port:chunk_elems"] = np.array([np.prod(comm.chunk((9, 5), 1)[1]), np.prod(comm.chunk((1000, 7), 0)[1])])
    return out


C645 = _rng(30).normal(size=(6, 4, 5)).astype(np.float32)
STATX = _rng(31).normal(size=(37, 4)).astype(np.float32)
W37 = _rng(32).uniform(0.5, 2.0, size=37)
LAB = _rng(33).integers(0, 6, size=37).astype(np.int64)
BIG1D = np.round(_rng(34).normal(size=4001) * 50).astype(np.float32)  # many ties
SQ7 = _rng(35).normal(size=(7, 7)).astype(np.float32)
MEDBLOBS = (_blobs(36, 203, 5, 3, scale=12.0)[0] + _rng(37).standard_t(3, size=(203, 5))).astype(np.float32)


def _collectives(ht, fn):
    """``fn()``'s result and, for the port, the collectives it ran and the
    bytes they brought this rank."""
    if not is_port(ht):
        return fn(), None
    ht.kernels.reset_kernel_stats()
    res = fn()
    return res, {"calls": {k: v["calls"] for k, v in ht.kernels.COLLECTIVES.items()},
                 "sent": {k: v["bytes"] for k, v in ht.kernels.COLLECTIVES.items()},
                 "received": dict(ht.kernels.RECEIVED)}


def case_manipulations(ht):
    """Every manipulation, the factories' rest and diff across ranks: the
    split axis moved, padded, rolled, flipped and cut at 9 rows on 4 ranks
    (an empty last chunk)."""
    a0, a1, an = ht.array(A95, split=0), ht.array(A95, split=1), ht.array(A95)
    v0, c0 = ht.array(V9, split=0), ht.array(C645, split=1)
    out = {
        "reshape": ht.reshape(a0, (5, 9)), "reshape_flat": ht.reshape(a0, (45,)), "reshape_s1": ht.reshape(a1, (3, 15)),
        "reshape_new_split": ht.reshape(a0, (15, 3), new_split=1), "reshape_method": a0.reshape(3, 3, 5),
        "flatten": ht.flatten(c0), "ravel": ht.ravel(a1), "flatten_method": a0.flatten(),
        "concatenate": ht.concatenate([a0, ht.array(A95[:4], split=0), an[:2]], axis=0),
        "concatenate1": ht.concatenate([a0, ht.array(A95[:, :2], split=0)], axis=1),
        "hstack": ht.hstack([v0, ht.array(V5, split=0)]), "vstack": ht.vstack([a0, ht.array(V5, split=0)]),
        "row_stack": ht.row_stack([a0, an[:1]]), "column_stack": ht.column_stack([v0, a0]),
        "stack": ht.stack([a0, a0 * 2], axis=1), "expand_dims": ht.expand_dims(a1, 0),
        "squeeze": ht.squeeze(ht.array(A95[:1], split=0), 0), "squeeze1": ht.array(C645[:, :1], split=0).squeeze(1),
        "flip0": ht.flip(a0, 0), "flip_all": ht.flip(c0), "fliplr": ht.fliplr(a1), "flipud": ht.flipud(a0),
        "roll0": ht.roll(a0, 3, 0), "roll_neg": ht.roll(a0, -11, 0), "roll_none": ht.roll(a1, 7), "roll1": ht.roll(a1, 2, 1),
        "rot90": ht.rot90(a0), "moveaxis": ht.moveaxis(ht.array(C645, split=0), 0, 2), "swapaxes": ht.swapaxes(a1, 0, 1),
        "pad0": ht.pad(a0, ((2, 3), (1, 0))), "pad_edge": ht.pad(a0, ((4, 2), (0, 1)), mode="edge"),
        "pad_reflect": ht.pad(a0, ((3, 3), (0, 0)), mode="reflect"), "pad_wrap": ht.pad(a0, ((10, 1), (0, 0)), mode="wrap"),
        "unfold": ht.unfold(a0, 0, 3, 2), "unfold1": ht.unfold(a0, 1, 2),
        "diag": ht.diag(v0), "diagonal": ht.diagonal(a0), "repeat": ht.repeat(a0, 2, axis=0), "tile": ht.tile(a0, (2, 1)),
        "broadcast_to": ht.broadcast_to(v0, (2, 9)),
        "broadcast_arrays": ht.broadcast_arrays(ht.array(A95[:, :1], split=0), ht.array(V5)),
        "split": ht.split(a0, [2, 7]), "hsplit": ht.hsplit(a1, [2]), "vsplit": ht.vsplit(a0, [4]),
        "dsplit": ht.dsplit(ht.array(C645, split=0), [2]), "balance": ht.balance(a0, copy=True),
        "redistribute": ht.redistribute(a0), "resplit": ht.resplit(a0, 1), "shape": ht.shape(a1),
        "diff0": ht.diff(a0, axis=0), "diff2": ht.diff(a0, n=2, axis=0, prepend=0.5, append=ht.array(A95[:2])),
        "diff1": ht.diff(a1, axis=1), "nonzero_3d": ht.nonzero(ht.array(C645 > 0.5, split=1)),
        "nonzero_s2": ht.nonzero(ht.array(C645 > 0.5, split=2)),
        "linspace": ht.linspace(-2, 3, 11, split=0), "logspace": ht.logspace(0, 1, 5, split=0),
        "meshgrid": ht.meshgrid(v0, ht.array(V5)), "asarray": ht.asarray(A95[:3], dtype=ht.float64),
        "scalar_to_1d": ht.scalar_to_1d(ht.array(2.5)),
    }
    return out


def case_sort(ht):
    """sort, topk and unique along the split axis (and beside it); for the
    port also the collectives of the 1-D sample sort of 4001 elements and
    the bytes they brought each rank."""
    x = ht.array(TIES95.reshape(-1), split=0)
    big = ht.array(BIG1D, split=0)
    (sv, si), coll = _collectives(ht, lambda: ht.sort(big))
    out = {"sort_big": (sv, si), "sort": ht.sort(x), "sort_desc": ht.sort(x, descending=True),
           "sort_nan": ht.sort(ht.array(NAN95.reshape(-1), split=0)),
           "sort_nan_desc": ht.sort(ht.array(NAN95.reshape(-1), split=0), descending=True),
           "sort_2d_split": ht.sort(ht.array(TIES95, split=0), axis=0),
           "sort_2d_other": ht.sort(ht.array(TIES95, split=0), axis=1),
           "sort_int": ht.sort(ht.array(I95.reshape(-1), split=0), descending=True),
           "topk": ht.topk(ht.array(TIES95, split=0), 3, dim=0), "topk_small": ht.topk(x, 5, largest=False),
           "topk_nan": ht.topk(ht.array(NAN95.reshape(-1), split=0), 6),
           "topk_other": ht.topk(ht.array(TIES95, split=0), 2, dim=1),
           "unique": ht.unique(x), "unique_inverse": ht.unique(ht.array(I95, split=1), return_inverse=True),
           "unique_axis": ht.unique(ht.array(np.concatenate([I95, I95[:3]]), split=0), axis=0),
           "unique_nan": ht.unique(ht.array(NAN95, split=0)), "unique_method": ht.array(I95, split=0).unique()}
    if coll is not None:
        out["port:sort_collectives"] = coll
    return out


def case_order_stats(ht):
    """percentile and median along the split axis (the key-bisection selection in the
    port) and beside it, the moments and the histograms across ranks."""
    x0, x1 = ht.array(STATX, split=0), ht.array(STATX, split=1)
    x64 = ht.array(STATX.astype(np.float64), split=0)
    pct, coll = _collectives(ht, lambda: ht.percentile(x0, [0, 25, 30, 50, 75, 100], axis=0))
    out = {
        "percentile0": pct, "percentile_none": ht.percentile(x0, 42.0), "percentile_ax1": ht.percentile(x0, [10, 90], axis=1),
        "percentile_methods": [ht.percentile(x0, 30, axis=0, interpolation=m) for m in ("lower", "higher", "nearest",
                                                                                      "midpoint")],
        "percentile_kd": ht.percentile(x1, [5, 95], axis=1, keepdims=True),
        "percentile_nan": ht.percentile(ht.array(NAN95, split=0), [25, 75], axis=0),
        "percentile_int": ht.percentile(ht.array(I95, split=0), 50, axis=0),
        "percentile_f64": ht.percentile(x64, [10, 50, 90], axis=0), "median_f64": ht.median(x64, axis=0),
        "median0": ht.median(x0, axis=0), "median_none": ht.median(x0), "median_ax1": ht.median(x0, axis=1),
        "median_even": ht.median(ht.array(STATX[:36], split=0), axis=0),
        "nanmean": ht.nanmean(ht.array(NAN95, split=0), axis=0), "nanmean_all": ht.nanmean(ht.array(NAN95, split=1)),
        "average": ht.average(x0, axis=0), "average_w": ht.average(x0, axis=0, weights=W37),
        "average_w_full": ht.average(x0, weights=ht.array(np.abs(STATX) + 0.1, split=0), returned=True),
        "cov": ht.cov(x0, rowvar=False), "cov_rows": ht.cov(ht.array(STATX.T.copy(), split=1)),
        "cov_s1": ht.cov(x1, rowvar=False), "skew": ht.skew(x64, axis=0), "skew_all": ht.skew(x64),
        "kurtosis": ht.kurtosis(x64, axis=0), "kurtosis_all": ht.kurtosis(ht.array(STATX.astype(np.float64), split=1)),
        "histogram": ht.histogram(x0, bins=7), "histc": ht.histc(x0, bins=5, min=-2.0, max=2.0),
        "bincount": ht.bincount(ht.array(LAB, split=0)), "bincount_w": ht.bincount(ht.array(LAB, split=0), weights=ht.array(W37, split=0)),
        "bucketize": ht.bucketize(x0, [-1.0, 0.0, 1.0]), "digitize": ht.digitize(x0, [-1.0, 0.0, 1.0]),
    }
    if coll is not None:
        out["port:percentile_collectives"] = coll
    return out


def case_setitem(ht):
    """Writes across the chunk boundaries of 9 rows on 4 ranks, with split
    and replicated values; reads by negative steps, masks and integer
    arrays."""
    def fresh(split=0):
        return ht.array(A95, split=split)

    out = {}
    m = A95 > 0.2
    writes = [
        ("slice_split_value", fresh, slice(2, 7), lambda: ht.array(A95[:5] * 10, split=0)),
        ("step", fresh, slice(1, 8, 3), lambda: 0.5),
        ("neg_step_split_value", fresh, slice(7, 0, -2), lambda: ht.array(A95[:4], split=0)),
        ("slice_replicated_value", fresh, slice(3, 6), lambda: ht.array(A95[:3])),
        ("cols_split1", lambda: fresh(1), (slice(None), slice(1, 4)), lambda: ht.array(A95[:, :3] * 2, split=1)),
        ("int_row", fresh, 4, lambda: 9.0),
        # a split value for a row one rank owns: every rank gathers the value (the others once returned first, and
        # the owner's gather hung)
        ("int_row_split_value", fresh, 4, lambda: ht.array(A95[0] * 3, split=0)),
        ("mask_scalar", fresh, lambda: ht.array(A95 > 0.5, split=0), lambda: 0.0),
        ("mask_split_values", fresh, lambda: ht.array(m, split=0),
         lambda: ht.array(np.arange(m.sum(), dtype=np.float32), split=0)),
        ("mask_split1", lambda: fresh(1), lambda: ht.array(A95 < 0, split=1), lambda: -1.0),
        ("int_array", fresh, [0, 4, 8], lambda: ht.array(A95[:3] + 100)),
        ("ellipsis", fresh, (Ellipsis, 2), lambda: 7.0),
    ]
    for name, make, key, value in writes:
        x = make()
        x[key() if callable(key) else key] = value()
        out[name] = x
    out.update({
        "get_neg_step": fresh()[::-2], "get_neg_step1": fresh(1)[:, ::-1],
        "get_mask": fresh()[ht.array(A95 > 0.3, split=0)], "get_mask1": fresh(1)[ht.array(A95 > 0.3, split=1)],
        "get_int_array": fresh()[[8, 0, 3, 3]], "get_int_array_cols": fresh()[:, [4, 0]],
        "get_coords": fresh()[ht.nonzero(fresh() > 1.0)],
    })
    return out


def case_norms(ht):
    """Norms, trace and dot over the split axis; for the port also the
    collectives each one ran."""
    a0, a1, v0 = ht.array(A95, split=0), ht.array(A95, split=1), ht.array(V9, split=0)
    calls = {
        "vector_norm0": lambda: ht.vector_norm(a0, axis=0), "vector_norm_inf": lambda: ht.vector_norm(a0, axis=0, ord=np.inf),
        "vector_norm_ninf": lambda: ht.vector_norm(a1, axis=1, ord=-np.inf), "vector_norm_0": lambda: ht.vector_norm(a0, axis=0, ord=0),
        "vector_norm_3": lambda: ht.vector_norm(a0, ord=3), "vector_norm_kd": lambda: ht.vector_norm(a1, keepdims=True),
        "matrix_norm_1": lambda: ht.matrix_norm(a0, ord=1), "matrix_norm_m1": lambda: ht.matrix_norm(a1, ord=-1),
        "matrix_norm_inf": lambda: ht.matrix_norm(a0, ord=np.inf), "matrix_norm_ninf": lambda: ht.matrix_norm(a1, ord=-np.inf),
        "matrix_norm_fro": lambda: ht.matrix_norm(a1), "norm_all": lambda: ht.norm(a0),
        "trace_s0": lambda: ht.trace(ht.array(SQ7, split=0), 1), "trace_s1": lambda: ht.trace(ht.array(SQ7, split=1), -2),
        "dot_00": lambda: ht.dot(v0, v0), "dot_0n": lambda: ht.dot(v0, ht.array(V9)),
        "dot_int": lambda: ht.dot(ht.array(I95[:, 0], split=0), ht.array(I95[:, 1], split=0)),
    }
    out = {}
    for name, call in calls.items():
        out[name], coll = _collectives(ht, call)
        if coll is not None:
            out[f"port:{name}"] = coll
    out["matrix_norm_nuc"] = ht.matrix_norm(a0, ord="nuc")
    out["matrix_norm_2"] = ht.matrix_norm(a1, ord=2)
    return out


def case_kmedians(ht):
    """KMedians and KMedoids on split-0 blobs with heavy-tailed noise; for
    the port also the collectives of the explicit-init KMedians fit."""
    x = ht.array(MEDBLOBS, split=0)
    km, coll = _collectives(ht, lambda: ht.cluster.KMedians(3, init=ht.array(MEDBLOBS[:3]), max_iter=8, tol=None).fit(x))
    out = {"centers": km.cluster_centers_, "labels": km.labels_, "n_iter": km.n_iter_,
           "predict": km.predict(ht.array(BLOBS_NEW, split=0))}
    km2 = ht.cluster.KMedians(3, init="random", random_state=4, max_iter=20).fit(x)
    out.update({"random_centers": km2.cluster_centers_, "random_labels": km2.labels_, "random_n_iter": km2.n_iter_})
    for name, kd in (("medoids", ht.cluster.KMedoids(3, init=ht.array(MEDBLOBS[:3]), max_iter=10)),
                     ("medoids_random", ht.cluster.KMedoids(3, init="random", random_state=5, max_iter=10))):
        kd.fit(x)
        out.update({f"{name}:centers": kd.cluster_centers_, f"{name}:labels": kd.labels_, f"{name}:n_iter": kd.n_iter_})
    if coll is not None:
        out["port:kmedians_collectives"] = coll
    return out


def _halo_stack(ht, x, which):
    """heat_tpu's stack of one side's halos over every inter-shard boundary
    that carries one; for the port the same stack built from each rank's own
    ``halo_prev``/``halo_next`` (rank r + 1 holds boundary r's previous-side
    halo, rank r its next-side one), gathered in rank order."""
    if not is_port(ht):
        h = getattr(x, which)
        return None if h is None else np.asarray(h)
    import torch

    comm, h = x.comm, getattr(x, which)
    shape = list(x.gshape)
    shape[x.split] = x.halo_size
    held = torch.tensor([h is not None])
    mine = h if h is not None else torch.zeros(shape, dtype=x._raw.dtype)
    flags = comm.allgather(held, 0, [1] * comm.size)
    parts = comm.allgather(mine.unsqueeze(0), 0, [1] * comm.size)
    keep = [r for r in range(comm.size) if bool(flags[r])]
    return parts[keep].numpy() if keep else None


def case_halos(ht):
    """get_halo along the split axis: 9 rows in chunks of 3, 3, 3, 0 (the
    empty last rank lends and gets nothing), halos of 1 to 4 rows (a chunk
    shorter than the halo carries none), a column split and a 3-D array;
    for the port also each rank's array_with_halos length and the halo
    batch's COLLECTIVES."""
    out = {}
    arrays = {"a93_s0": ht.array(A93, split=0), "a95_s1": ht.array(A95, split=1),
              "i95_s0": ht.array(I95, split=0), "c645_s2": ht.array(C645, split=2)}
    for name, x in arrays.items():
        for hs in (1, 2, 3, 4):
            before = {k: dict(v) for k, v in ht.kernels.COLLECTIVES.items()} if is_port(ht) else None
            x.get_halo(hs)
            if is_port(ht):
                after = ht.kernels.COLLECTIVES.get("halo", {"calls": 0, "bytes": 0})
                prior = before.get("halo", {"calls": 0, "bytes": 0})
                out[f"port:rank:{name}:{hs}:halo_calls"] = after["calls"] - prior["calls"]
                out[f"port:rank:{name}:{hs}:halo_bytes"] = after["bytes"] - prior["bytes"]
                out[f"port:rank:{name}:{hs}:with_halos"] = int(x.array_with_halos().shape[x.split])
                out[f"port:rank:{name}:{hs}:lshape"] = int(x.lshape[x.split])
            out[f"{name}:{hs}:size"] = x.halo_size
            out[f"{name}:{hs}:prev"] = _halo_stack(ht, x, "halo_prev")
            out[f"{name}:{hs}:next"] = _halo_stack(ht, x, "halo_next")
    return out


SIG = _rng(12).normal(size=41).astype(np.float32)
TAPS = {m: _rng(13 + m).normal(size=m).astype(np.float32) for m in (1, 3, 4, 5, 9)}


def case_convolve(ht):
    """convolve of a split signal over the halos: 41 samples (chunks of 11,
    11, 11, 8) with kernels of 1 to 9 taps in the three modes; 9 samples
    (an empty last rank) with 3 taps; 7 samples (chunks of 2 shorter than a
    5-tap kernel's halo: the gathered route); float64, int32 and complex64
    signals; a kernel longer than the signal (the operands swap)."""
    out = {}
    a = ht.array(SIG, split=0)
    for m, taps in TAPS.items():
        for mode in ("full", "same", "valid"):
            out[f"{m}:{mode}"] = attempt(lambda: ht.convolve(a, ht.array(taps), mode))
    for n, m in ((9, 3), (7, 5)):
        for mode in ("full", "same", "valid"):
            out[f"n{n}:{m}:{mode}"] = ht.convolve(ht.array(SIG[:n], split=0), ht.array(TAPS[m]), mode)
    out["float64"] = ht.convolve(ht.array(SIG.astype(np.float64), split=0), ht.array(TAPS[5].astype(np.float64)))
    out["int32"] = ht.convolve(ht.array(np.round(SIG * 4).astype(np.int32), split=0), ht.array(np.array([1, 2, 1], np.int32)))
    out["complex64"] = ht.convolve(ht.array((SIG + 1j * SIG[::-1]).astype(np.complex64), split=0),
                                   ht.array(TAPS[3].astype(np.complex64)), "same")
    out["swap"] = ht.convolve(ht.array(SIG[:5], split=0), ht.array(SIG, split=0), "full")
    return out


CPX = (_rng(14).normal(size=(9, 5)) + 1j * np.round(_rng(15).normal(size=(9, 5)))).astype(np.complex64)
CPX[:, 2] = np.round(CPX[:, 2].real) + 1j * CPX[:, 2].imag  # equal real parts: the imaginary part decides


def case_complex(ht):
    """Complex arrays across ranks: vdot (one allreduce of the scalar),
    sums, means and variances along the split axis, the lexicographic
    max/min and comparisons, complex_math, a complex product over a split
    contracted axis, and resplit (alltoall)/gather of complex chunks.
    heat_tpu's XLA program cannot reduce a complex max over a sharded axis
    on the CPU (UNIMPLEMENTED), so those references are numpy's, whose
    complex order is the same lexicographic one."""
    c0, c1 = ht.array(CPX, split=0), ht.array(CPX, split=1)

    def lex(fn, name, axis):
        return fn() if is_port(ht) else ht.array(getattr(np, name)(CPX, axis=axis))
    out = {}
    if is_port(ht):
        before = {k: dict(v) for k, v in ht.kernels.COLLECTIVES.items()}
        out["vdot"] = ht.vdot(c0, c0)
        out["port:vdot_collectives"] = {k: v["calls"] - before.get(k, {}).get("calls", 0)
                                        for k, v in ht.kernels.COLLECTIVES.items()
                                        if v["calls"] != before.get(k, {}).get("calls", 0)}
    else:
        out["vdot"] = ht.vdot(c0, c0)
    out.update({
        "vdot_s1": ht.vdot(c1, c1), "vecdot": ht.vecdot(c0, c0), "sum0": ht.sum(c0, axis=0), "sum": ht.sum(c1),
        "mean0": ht.mean(c0, axis=0), "var0": ht.var(c0, axis=0), "std": ht.std(c1),
        "max": lex(lambda: ht.max(c0), "max", None), "min0": lex(lambda: ht.min(c0, axis=0), "min", 0),
        "max1": lex(lambda: ht.max(c1, axis=1), "max", 1), "maximum": ht.maximum(c0, ht.array(CPX[::-1].copy())),
        "lt": c0 < ht.array(CPX[::-1].copy(), split=0), "ge": c1 >= 0.5 + 0.5j, "abs": ht.abs(c0),
        "angle": ht.angle(c1), "conj": ht.conj(c0), "conjugate": ht.conjugate(c1), "real": ht.real(c1),
        "imag": ht.imag(c0), "iscomplex": ht.iscomplex(c0), "isreal": ht.isreal(ht.real(c1)),
        "matmul": ht.matmul(ht.conj(c0).T, c0), "resplit": c0.resplit(1), "gather": c1.resplit(None),
        "argmax": attempt(lambda: ht.argmax(c0)),
    })
    return out


SMALL = {
    "uint8": _rng(16).integers(0, 255, size=(9, 5)).astype(np.uint8),
    "int8": _rng(17).integers(-128, 127, size=(9, 5)).astype(np.int8),
    "int16": _rng(18).integers(-3000, 3000, size=(9, 5)).astype(np.int16),
    "float16": _rng(19).normal(size=(9, 5)).astype(np.float16),
}


def case_small_dtypes(ht):
    """The small and half types moved across ranks (gloo takes no int16: it
    moves as int32): resplit both ways (alltoall), gather, the split-axis
    sum, max and mean, a setitem across ranks, and bfloat16 through the
    same; for the port also ring_shift of each rank's chunk."""
    out = {}
    for name, host in list(SMALL.items()) + [("bfloat16", SMALL["float16"])]:
        x0 = ht.array(host, split=0)
        if name == "bfloat16":
            x0 = x0.astype(ht.bfloat16)
        x1 = x0.resplit(1)
        y = x0.copy()
        y[2:7, 1] = 3
        out.update({
            f"{name}:s0": x0, f"{name}:to1": x1, f"{name}:back": x1.resplit(0), f"{name}:gather": x0.resplit(None),
            f"{name}:sum0": ht.sum(x0, axis=0), f"{name}:max": ht.max(x0), f"{name}:mean0": ht.mean(x0, axis=0),
            f"{name}:setitem": y,
        })
        if is_port(ht) and ht.get_comm().size == 4:  # 9 rows: chunks of 3, 3, 3 and an empty one
            import torch

            comm = ht.get_comm()
            mine = x0.larray if x0.lshape[0] == 3 else x0.larray.new_zeros((3, 5))
            got = comm.ring_shift(mine)
            nxt = (comm.rank + 1) % comm.size
            whole = x0.numpy()
            want = whole[3 * nxt:3 * nxt + 3] if nxt < 3 else np.zeros((3, 5), whole.dtype)
            got_h = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
            out[f"port:{name}:ring_shift_ok"] = bool(np.array_equal(got_h, want))
    return out


def case_pad_modes(ht):
    """pad's statistic and ramp modes along and beside the split axis (9
    rows on 4 ranks: an empty last chunk), float32 and int32."""
    out = {}
    for split in (0, 1):
        for name, host in (("f", A95), ("i", I95)):
            x = ht.array(host, split=split)
            for mode in ("linear_ramp", "maximum", "mean", "median", "minimum", "empty"):
                out[f"{name}{split}:{mode}"] = ht.pad(x, ((2, 3), (1, 2)), mode)
    return out


# the directory the ranks of a group share for the files of case_io (set by main); elsewhere a fresh one
CASE_DIR = None


def _case_dir():
    import tempfile

    return CASE_DIR or tempfile.mkdtemp(prefix="ht_case_")


IO_FORMATS = (("h5", ".h5", ("x",), {}), ("cdf1", ".nc", ("x",), {"format": "NETCDF3_CLASSIC"}),
              ("cdf2", ".nc", ("x",), {"format": "NETCDF3_64BIT"}), ("csv", ".csv", (), {}))


def case_io(ht):
    """Saves of split arrays (every rank writes its rows in rank order) and
    split-0/1 loads (every rank reads only its rows) of HDF5, classic
    netCDF and CSV files, 9 rows on 4 ranks (an empty last chunk), and a
    row window; for the port also the CSV parser's route."""
    d = _case_dir()
    out = {"supports": (ht.supports_hdf5(), ht.supports_netcdf())}
    if is_port(ht):
        ht.kernels.reset_kernel_stats()
    for fmt, ext, args, kw in IO_FORMATS:
        path = os.path.join(d, f"io_{fmt}{ext}")
        for ssave in (0, 1):
            ht.save(ht.array(A95, split=ssave), path, *args, **kw)
            for split in (None, 0, 1):
                out[f"{fmt}:save{ssave}:load{split}"] = ht.load(path, *args, split=split)
        out[f"{fmt}:window"] = ht.load(path, *args, split=0, start=2, stop=8)
    one = os.path.join(d, "io_direct")
    ht.save_hdf5(ht.array(A93, split=0), one + ".h5", "y")
    ht.save_netcdf(ht.array(A93, split=1), one + ".nc", "y", format="NETCDF3_64BIT")
    ht.save_csv(ht.array(I95, split=0), one + ".csv")
    out.update({
        "direct:h5": ht.load_hdf5(one + ".h5", "y", split=1),
        "direct:nc": ht.load_netcdf(one + ".nc", "y", split=0, start=1),
        "direct:csv": ht.load_csv(one + ".csv", dtype=ht.int32, split=0),
    })
    if is_port(ht):
        out["port:csv_routes"] = {k: v for k, v in ht.KERNEL_STATS.items() if k.startswith("csv.")}
    return out


def case_stream(ht):
    """The stream path over split-0 chunks (203 rows in chunks of 64: the
    tail of 11 rows leaves the last rank 2): StreamingMoments, Cov,
    Histogram, HyperLogLog, CountMinTopK and StreamingKMeans (global and
    minibatch); for the port also the collectives of each pass, the KLL
    percentiles against numpy within the sketch's bound, and
    merge_processes of per-rank moments through tree_merge."""
    it = ht.stream.ChunkIterator(BLOBS, 64, split=0)
    out = {}

    def host(t):
        return t.detach().cpu().numpy() if is_port(ht) else np.asarray(t)

    def folded(est):
        if is_port(ht):
            ht.kernels.reset_kernel_stats()
        for c in ht.stream.Prefetcher(it, depth=2):
            est.update(c)
        if is_port(ht):
            out[f"port:calls:{type(est).__name__}"] = {k: v["calls"] for k, v in ht.kernels.COLLECTIVES.items()}
        return est

    m = folded(ht.stream.StreamingMoments(ddof=1))
    cov = folded(ht.stream.StreamingCov())
    hist = folded(ht.stream.StreamingHistogram(8, (-30.0, 30.0)))
    hll = folded(ht.stream.HyperLogLog(8))
    ints = ht.stream.ChunkIterator(np.round(BLOBS).astype(np.float32), 50, split=0)
    cm = ht.stream.CountMinTopK(256, 4, 8)
    for c in ints:
        cm.update(c)
    if is_port(ht):
        ht.kernels.reset_kernel_stats()
    km = ht.cluster.StreamingKMeans(3, init=ht.array(BLOBS[:3]), max_iter=4, tol=None).fit(it, prefetch_depth=2)
    if is_port(ht):
        out["port:calls:StreamingKMeans"] = {k: v["calls"] for k, v in ht.kernels.COLLECTIVES.items()}
    mb = ht.cluster.StreamingKMeans(3, init=ht.array(BLOBS[:3]), max_iter=1, algorithm="minibatch").fit(it)
    cands, counts = cm.topk(4)
    out.update({
        "mean": m.mean, "var": m.var, "cov": cov.cov, "hist": hist.hist, "hll": host(hll._regs),
        "hll_distinct": hll.distinct(), "cm_table": host(cm._table).astype(np.int64), "cm_top": cands,
        "cm_counts": counts, "km_centers": km.cluster_centers_, "km_inertia": km.inertia_,
        "mb_centers": mb.cluster_centers_, "chunks": len(it), "lockstep": ht.collective_lockstep(m.mean),
        "rounds4": ht.tree_merge_rounds(4), "rounds3": ht.tree_merge_rounds(3),
    })
    if is_port(ht):
        comm = ht.get_comm()
        q = np.array([1.0, 25.0, 50.0, 75.0, 99.0])
        kll = ht.stream.KLLSketch()
        for c in it:
            kll.update(c)
        sx = np.sort(BLOBS.ravel())
        got = kll.percentile(q).numpy()
        target = q / 100 * (sx.size - 1)
        lo, hi = np.searchsorted(sx, got, "left"), np.searchsorted(sx, got, "right")
        err = np.maximum(0.0, np.maximum(lo - target, target - hi)) / sx.size  # the closest rank among ties
        out["port:kll_within_eps"] = bool((err <= kll.eps).all())
        out["port:kll"] = got
        # per-rank moments of this rank's own rows, merged in log2(4) = 2 rounds of the butterfly
        mine = ht.stream.StreamingMoments()
        for c in ht.stream.ChunkIterator(BLOBS[comm.rank::comm.size], 16, comm=ht.SELF):
            mine.update(c)
        ht.kernels.reset_kernel_stats()
        moves = dict(ht.MOVE_STATS)
        mine.merge_processes()
        out["port:tree_merge_calls"] = ht.kernels.COLLECTIVES.get("tree_merge", {}).get("calls", 0)
        out["port:tree_merge_counted"] = {k: ht.MOVE_STATS[k] - moves[k] for k in ("tree_merges", "tree_merge_rounds")}
        whole = ht.stream.StreamingMoments()
        for c in ht.stream.ChunkIterator(BLOBS, 64, split=None):
            whole.update(c)
        out["port:merged_mean"] = mine.mean.numpy()
        out["port:merged_var"] = mine.var.numpy()
        out["port:merged_close"] = bool(np.allclose(mine.mean.numpy(), whole.mean.numpy(), rtol=1e-5, atol=1e-5)
                                        and np.allclose(mine.var.numpy(), whole.var.numpy(), rtol=1e-5, atol=1e-5))
        state = (ht.array(np.float32(comm.rank + 1)).larray, ht.array(np.arange(3, dtype=np.int64) * comm.rank).larray)
        merged = ht.tree_merge(state, lambda a, b: (a[0] * 2 + b[0], a[1] + b[1]))
        out["port:tree_merge_rank_order"] = (float(merged[0]), merged[1].tolist())
    return out


# ------------------------------------------------- ragged layouts, flatmove, the parallel primitives
RAG = _rng(12).integers(-8, 9, size=(19, 5)).astype(np.float32)  # small integers: sums exact in any order


def _tmap(counts, gshape, split):
    """A target map: ``gshape`` on every rank, ``counts`` along ``split``."""
    t = np.tile(np.asarray(gshape, dtype=np.int64), (len(counts), 1))
    t[:, split] = counts
    return t


def _maps(p, n):
    """Partitions of n over p ranks: all on the last, all on the first, an
    empty last rank, and a skew with an empty rank inside."""
    if p == 1:
        return {"one": [n]}
    tail, head = [0] * p, [0] * p
    tail[-1], head[0] = n, n
    empty = [n // 2] + [(n - n // 2) // (p - 2)] * (p - 2) + [0] if p > 2 else [n, 0]
    empty[-2] += n - sum(empty)
    skew = [n - n // 3 - n // 4, 0] + [n // 3] + [n // 4] + [0] * (p - 4) if p >= 4 else head[::-1]
    return {"tail": tail, "head": head, "empty": empty, "skew": skew}


class _Counters:
    """LAYOUT_STATS/MOVE_STATS deltas of the ``with`` block."""

    def __init__(self, ht):
        self.ht = ht

    def __enter__(self):
        self.before = (dict(self.ht.LAYOUT_STATS), dict(self.ht.MOVE_STATS))
        return self

    def __exit__(self, *exc):
        lay, mov = self.before
        self.delta = {"rebalances": self.ht.LAYOUT_STATS["rebalances"] - lay["rebalances"],
                      **{k: self.ht.MOVE_STATS[k] - mov[k] for k in ("ragged_moves", "bucket_moves")}}
        return False


def _ragged(ht, full, split, counts):
    x = ht.array(full, split=split)
    x.redistribute_(target_map=_tmap(counts, full.shape, split))
    return x


def case_redistribute(ht):
    """Tail, head and empty-shard maps on split 0 and split 1, a chain of
    ragged-to-ragged moves, balance_, resplit_ of a ragged array, the
    out-of-place forms and the lshape_map hint, with the counters of each."""
    p = ht.get_comm().size
    out = {}
    for split, full in ((0, RAG), (1, np.ascontiguousarray(RAG.T))):
        for name, counts in _maps(p, full.shape[split]).items():
            x = ht.array(full, split=split)
            seen = dict(ht.kernels.RECEIVED) if is_port(ht) else None
            with _Counters(ht) as c:
                x.redistribute_(target_map=_tmap(counts, full.shape, split))
            out[f"s{split}:{name}"], out[f"s{split}:{name}:counters"] = x, c.delta
            if is_port(ht):  # the bytes this rank received, and the rows it lacked
                comm = ht.get_comm()
                got = ht.kernels.RECEIVED.get("flatmove.ragged", 0) - seen.get("flatmove.ragged", 0)
                lo, hi = sum(counts[: comm.rank]), sum(counts[: comm.rank + 1])
                c_lo, c_n = comm.chunk(full.shape, split)[0], comm.chunk(full.shape, split)[1][split]
                lacked = (hi - lo) - max(0, min(hi, c_lo + c_n) - max(lo, c_lo))
                out[f"port:rank:s{split}:{name}:received"] = (got, lacked * full.size // full.shape[split] * 4)
            out[f"s{split}:{name}:balanced"] = (x.balanced, x.is_balanced(), x.counts_displs())
    maps = list(_maps(p, RAG.shape[0]).values())
    x = ht.array(RAG, split=0)
    with _Counters(ht) as c:
        for counts in maps + maps[::-1]:
            x.redistribute_(target_map=_tmap(counts, RAG.shape, 0))
    out["chain"], out["chain:counters"] = x, c.delta
    b = _ragged(ht, RAG, 0, maps[0])
    with _Counters(ht) as c:
        b.balance_()
        b.balance_()  # balanced already: nothing moves, nothing counted
    out["balance_"], out["balance_:counters"] = b, c.delta
    r = _ragged(ht, RAG, 0, maps[-1])
    with _Counters(ht) as c:
        r.resplit_(0)  # its own split: stays ragged
        r.resplit_(1)
    out["resplit_"], out["resplit_:counters"] = r, c.delta
    src = _ragged(ht, RAG, 0, maps[1])
    with _Counters(ht) as c:
        moved = ht.redistribute(src, target_map=_tmap(maps[0], RAG.shape, 0))
        bal = ht.balance(src, copy=True)
    out.update({"redistribute": moved, "balance_copy": bal, "out_of_place:counters": c.delta,
                "hint": attempt(lambda: src.redistribute_(lshape_map=src.comm.lshape_map(src.gshape, 0))),
                "to_split_1": _ragged(ht, RAG, 0, maps[2]).redistribute_(target_map=_tmap(
                    [int(v) for v in ht.get_comm().lshape_map(RAG.shape, 1)[:, 1]], RAG.shape, 1)),
                "bad_sum": attempt(lambda: ht.array(RAG, split=0).redistribute_(
                    target_map=_tmap([RAG.shape[0] + 1] + [0] * (p - 1), RAG.shape, 0)))})
    out["src"] = src  # unchanged by the out-of-place forms
    return out


def case_ragged_ops(ht):
    """Elementwise ops, reductions, cumulative ops, nonzero, copy and astype
    on ragged arrays with no rebalance and no move; a move only to align
    two layouts (into the first ragged operand's); a rebalance for getitem,
    setitem and out=."""
    p = ht.get_comm().size
    maps = _maps(p, RAG.shape[0])
    tail, head = maps.get("tail", [RAG.shape[0]]), maps.get("head", [RAG.shape[0]])
    x, y = _ragged(ht, RAG, 0, tail), _ragged(ht, RAG + 1.0, 0, tail)
    with _Counters(ht) as c:
        res = {
            "add": x + y, "mul": x * y, "sum": x.sum(), "sum0": ht.sum(x, axis=0), "max": ht.max(x),
            "min1": ht.min(x, axis=1), "sum1_kd": ht.sum(x, axis=1, keepdims=True), "mean1": ht.mean(x, axis=1),
            "mean0": ht.mean(x, axis=0), "std0": ht.std(x, axis=0), "nonzero": ht.nonzero(x),
            "cumsum0": ht.cumsum(x, 0), "cumsum1": ht.cumsum(x, 1), "cumprod0": ht.cumprod(x / 8.0, 0),
            "copy": x.copy(), "astype": x.astype(ht.float64), "abs_gt": ht.abs(x) > 2, "exp": ht.exp(x / 8.0),
            "row": x - ht.array(RAG[0]), "repl": ht.array(RAG) * x, "scalar": 2.5 * x - 1,
        }
    res["in_place:counters"] = c.delta
    e = _ragged(ht, RAG, 0, maps.get("empty", [RAG.shape[0]]))
    with _Counters(ht) as c:
        res.update({"e_nonzero": ht.nonzero(e > 3), "e_sum0": ht.sum(e, axis=0), "e_max0": ht.max(e, axis=0),
                    "e_cumsum": ht.cumsum(e, 0), "e_mean0": ht.mean(e, axis=0)})
    res["empty:counters"] = c.delta
    a, b = _ragged(ht, RAG, 0, tail), _ragged(ht, RAG * 2.0, 0, head)
    with _Counters(ht) as c:
        res["mismatch"] = a + b
    res["mismatch:counters"] = c.delta
    with _Counters(ht) as c:
        res["canonical_first"] = ht.array(RAG, split=0) - a
    res["canonical_first:counters"] = c.delta
    t = ht.array(RAG, split=0)
    target = _tmap(tail, RAG.shape, 0)
    with _Counters(ht) as c:
        t.redistribute_(target_map=target)
        z = (t + 1.0) * 2.0
        z.redistribute_(target_map=target)
    res["round_trip"], res["round_trip:counters"] = z, c.delta
    g, s, o = _ragged(ht, RAG, 0, head), _ragged(ht, RAG, 0, head), _ragged(ht, RAG, 0, head)
    with _Counters(ht) as c:
        res["getitem"] = g[1:-1]
    res["getitem:counters"] = c.delta
    with _Counters(ht) as c:
        s[1] = 7.0
    res["setitem"], res["setitem:counters"] = s, c.delta
    with _Counters(ht) as c:
        res["out"] = ht.add(o, 1.0, out=ht.zeros(RAG.shape, split=0))
    res["out:counters"] = c.delta
    # consumers of the ceil-div layout, values only: the halos (the skip rule on the ragged counts) and a product
    for side in ("halo_prev", "halo_next"):  # a fresh array each: heat_tpu's first halo read rebalances it
        hx = _ragged(ht, RAG, 0, maps.get("skew", head))
        hx.get_halo(2)
        res[side] = _halo_stack(ht, hx, side)
    mm = _ragged(ht, RAG, 0, tail)
    res["matmul"] = ht.matmul(mm.T, mm)
    if is_port(ht):  # heat_tpu rebalances the sum and keeps x's old lcounts (ROADMAP.md, Queue C caveats)
        i = _ragged(ht, RAG, 0, head)
        with _Counters(ht) as c:
            i += 1.0
        res["port:iadd"] = (i.lcounts == tuple(head) or p == 1, bool(np.array_equal(i.numpy(), RAG + 1.0)), c.delta)
    return res


def case_ragged_kmeans(ht):
    """The slice's path at a small size: a skewed map with an empty rank,
    standardize in place, KMeans on the ragged array (one rebalance, at the
    fit's first read of larray)."""
    p = ht.get_comm().size
    n = BLOBS.shape[0]
    counts = [n // 2, n // 4, n - n // 2 - n // 4] + [0] * (p - 3) if p >= 3 else [n] + [0] * (p - 1)
    x = _ragged(ht, BLOBS, 0, counts)
    init = ht.array(((BLOBS - BLOBS.mean(0)) / BLOBS.std(0))[:3].astype(np.float32))
    with _Counters(ht) as c:
        z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
    out = {"z:counters": c.delta, "z:lcounts": z.lcounts}
    with _Counters(ht) as c:
        km = ht.cluster.KMeans(n_clusters=3, init=init, max_iter=5, tol=None).fit(z)
    out.update({"fit:counters": c.delta, "z_after_fit:balanced": z.balanced, "labels": km.labels_,
                "centers": km.cluster_centers_, "inertia": float(km.inertia_), "z": z})
    return out


def _jax_ragged(ht, buf, gshape, split, counts):
    """heat_tpu's ragged DNDarray of a padded buffer (blocks of ``buf``
    holding ``counts`` rows each)."""
    return ht.DNDarray._from_ragged(buf, gshape, ht.canonical_heat_type(buf.dtype), split, counts,
                                    comm=ht.get_comm())


def case_flatmove(ht):
    """ragged_move, bucket_move, strided_take and reshape_via_flatmove: the
    port on each rank's tensor, heat_tpu on its padded buffers."""
    comm = ht.get_comm()
    p, me = comm.size, comm.rank
    fm = ht.parallel.flatmove
    out = {}
    x = ht.array(RAG, split=0)
    canon = [int(c) for c in comm.lshape_map(RAG.shape, 0)[:, 0]]
    for name, counts in _maps(p, RAG.shape[0]).items():
        with _Counters(ht) as c:
            if is_port(ht):
                moved = ht.DNDarray._from_ragged(fm.ragged_move(x.larray, 0, canon, counts, comm), RAG.shape,
                                                 x.dtype, 0, counts, comm=comm)
            else:
                buf = fm.ragged_move(x.larray, 0, canon, counts, max(1, max(counts)), comm)
                moved = _jax_ragged(ht, buf, RAG.shape, 0, counts)
        out[f"ragged:{name}"], out[f"ragged:{name}:counters"] = moved, c.delta
    # bucket_move: rank r sends (r + d) % 3 rows of its own block to rank d
    matrix = [[(r + d) % 3 for d in range(p)] for r in range(p)]
    src = [RAG[3 * r : 3 * r + sum(matrix[r])] for r in range(p)]
    recv = [sum(matrix[r][d] for r in range(p)) for d in range(p)]
    with _Counters(ht) as c:
        if is_port(ht):
            got = fm.bucket_move(ht.array(src[me]).larray, 0, matrix, comm)
            bucket = ht.DNDarray._from_ragged(got, (sum(recv), 5), ht.float32, 0, recv, comm=comm)
        else:
            block = max(len(s_) for s_ in src)
            buf = ht.array(np.concatenate([np.pad(s_, ((0, block - len(s_)), (0, 0))) for s_ in src])).larray
            got = fm.bucket_move(buf, 0, matrix, max(recv), comm)
            bucket = _jax_ragged(ht, got, (sum(recv), 5), 0, recv)
    out["bucket"], out["bucket:counters"] = bucket, c.delta
    for start, stop, step in ((1, 19, 3), (0, 19, 1), (17, 19, 5), (5, 5, 2)):
        if is_port(ht):
            t, m = fm.strided_take(x.larray, 0, 19, start, stop, step, comm)
            taken = ht.DNDarray(t, gshape=(m, 5), split=0, comm=comm)
        else:
            t, m = fm.strided_take(x.larray, 0, 19, start, stop, step, comm)
            taken = ht.DNDarray._from_buffer(t, (m, 5), ht.float32, 0, comm=comm)
        out[f"strided:{start}:{stop}:{step}"] = taken
    for shape in ((5, 19), (95,), (1, 95)):
        t = fm.reshape_via_flatmove(x.larray, RAG.shape, shape, comm)
        out[f"reshape:{shape}"] = ht.DNDarray(t, gshape=shape, split=0, comm=comm) if is_port(ht) else \
            ht.DNDarray._from_buffer(t, shape, ht.float32, 0, comm=comm)
    return out


_ATT2 = {n: [_rng(20 + i).normal(size=(n, 8)).astype(np.float32) for i in range(3)] for n in (24, 23)}
_ATT3 = {n: [_rng(30 + i).normal(size=(n, h, 8)).astype(np.float32) for i in range(3)] for n, h in ((24, 4), (23, 3))}


def case_parallel(ht):
    """halo_exchange, ring_map, ring_reduce, ring_attention and
    ulysses_attention, full and causal, divisible and not: the port on
    DNDarrays, heat_tpu on its global arrays (wrapped back for the
    comparison)."""
    comm = ht.get_comm()
    par = ht.parallel
    port = is_port(ht)

    def inp(a):
        return ht.array(a, split=0) if port else ht.array(a, split=0)._logical()

    def res(v):
        return v if port else ht.array(v, split=0)

    out = {}
    for h in (1, 2):
        for name, a in (("rag", RAG), ("div", RAG[:16])):
            out[f"halo:{name}:{h}"] = res(par.halo_exchange(inp(a), h, comm))
    # tiles written with operators and methods both array types have (this module imports neither backend)
    d2 = lambda a, b: ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)  # noqa: E731
    row_min = lambda t: t.amin(1) if hasattr(t, "amin") else t.min(axis=1)  # noqa: E731
    xs, ys = RAG[:8], RAG[4:16] / 2.0
    out["ring_map"] = res(par.ring_map(d2, inp(xs), inp(ys), comm))
    out["ring_map_indivisible"] = attempt(lambda: par.ring_map(d2, inp(RAG), inp(ys), comm))
    out["ring_reduce"] = res(par.ring_reduce(lambda a, b: row_min(d2(a, b)), lambda s_, t: s_ + (t - s_) * (t < s_),
                                             lambda a: a[:, 0] * 0 + 1e30, inp(xs), inp(ys), comm))
    for n, qkv in _ATT2.items():
        for causal in (False, True):
            out[f"ring:{n}:{causal}"] = res(par.ring_attention(*(inp(a) for a in qkv), comm, causal=causal))
    for n, qkv in _ATT3.items():
        for causal in (False, True):
            out[f"ulysses:{n}:{causal}"] = res(par.ulysses_attention(*(inp(a) for a in qkv), comm, causal=causal))
    if port:  # where a group runs, a DeviceMesh of the ranks (every rank builds it)
        for name, m in (("flat", par.make_mesh()), ("hierarchical", par.make_hierarchical_mesh(2))):
            out[f"port:mesh:{name}"] = repr((type(m).__name__, tuple(m.shape), tuple(m.mesh_dim_names), m.mesh.tolist()))
    return out


# ---------------------------------------------- the ML long tail and training
# GaussianNB and Lasso run the same code on both packages; the training cases (data_parallel, daso,
# attention_grad, dryrun) need jax, flax and optax on heat_tpu's side, which this module never imports:
# their references are tests/test_torch_dist.py's REFERENCES.
GNB_X, GNB_Y = _blobs(40, 240, 5, 3, scale=2.0)
LASSO_X = np.concatenate([np.ones((256, 1), np.float32), TALL[:, :6]], axis=1)
LASSO_Y = (LASSO_X @ np.array([0.5, 2.0, 0.0, -1.0, 0.0, 0.0, 3.0], np.float32)
           + 0.01 * _rng(43).normal(size=256)).astype(np.float32)
# the MLP of tests/test_dp_equivalence.py (8 -> 16 -> tanh -> 1) as a flax variable tree of numpy arrays
_W = _rng(44)
DP_TREE = {"params": {
    "Dense_0": {"kernel": (_W.normal(size=(8, 16)) * 0.3).astype(np.float32), "bias": np.zeros(16, np.float32)},
    "Dense_1": {"kernel": (_W.normal(size=(16, 1)) * 0.3).astype(np.float32), "bias": np.zeros(1, np.float32)},
}}
DP_X = _rng(45).normal(size=(6, 30, 8)).astype(np.float32)  # 30 rows: 8, 8, 8 and 6 on four ranks
DP_Y = _rng(46).normal(size=(6, 30, 1)).astype(np.float32)
DASO_X = _rng(47).normal(size=(12, 16, 8)).astype(np.float32)  # group g's rows: [8 g, 8 g + 8)
DASO_Y = _rng(48).normal(size=(12, 16, 1)).astype(np.float32)
DASO_EPOCHS, DASO_BATCHES, DASO_LR, DP_LR = 4, 3, 0.05, 0.05
# lengths and head counts the four ranks do not divide
ATTG2 = {23: [_rng(50 + i).normal(size=(23, 8)).astype(np.float32) for i in range(3)]}
ATTG3 = {23: [_rng(60 + i).normal(size=(23, 3, 8)).astype(np.float32) for i in range(3)]}


def _reference_elsewhere(ht):
    if not is_port(ht):
        raise NotImplementedError("heat_tpu's side of this case is tests/test_torch_dist.py's REFERENCES")


def case_gaussian_nb(ht):
    """GaussianNB fit at split 0 (one allreduce of k (2f + 1) values merges
    the ranks' class statistics) and its predictions (partial_fit and the
    posteriors are held at world size 1 in tests/test_torch_ml.py)."""
    n0 = 203
    x, y = ht.array(GNB_X[:n0], split=0), ht.array(GNB_Y[:n0], split=0)
    nb, coll = _collectives(ht, lambda: ht.naive_bayes.GaussianNB().fit(x, y))
    out = {a: getattr(nb, a) for a in ("classes_", "theta_", "sigma_", "class_prior_", "class_count_")}
    out["epsilon"] = float(nb.epsilon_)
    out["predict"] = nb.predict(ht.array(GNB_X[n0:], split=0))
    if is_port(ht):
        out["port:fit_collectives"] = coll["calls"]
    return out


def case_lasso(ht):
    """Lasso at split 0: coordinate descent (one scalar allreduce per
    coordinate), proximal-SGD steps, predict."""
    x, y = ht.array(LASSO_X, split=0), ht.array(LASSO_Y, split=0)
    las, coll = _collectives(ht, lambda: ht.regression.Lasso(lam=0.01, max_iter=50).fit(x, y))
    out = {"theta": las.theta, "n_iter": las.n_iter, "predict": las.predict(x)}
    sgd = ht.regression.Lasso(lam=0.01)
    for _ in range(3):
        sgd.partial_fit(x, y, lr=0.1)
    out["sgd_theta"] = sgd.theta
    if is_port(ht):
        out["port:fit_collectives"] = coll["calls"]
    return out


def _mlp(ht):
    import torch

    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
    model.load_state_dict(ht.convert.flax_to_state_dict(DP_TREE, model))
    return model.to(ht.get_device().torch_device)


def _params(model, prefix, out):
    for name, p in model.named_parameters():
        out[f"{prefix}:{name}"] = p.detach().cpu().numpy().copy()


def _mse(pred, target):
    return ((pred - target) ** 2).mean()


def case_data_parallel(ht):
    """DataParallel with uneven shards (30 rows: 8, 8, 8, 6), SGD with
    momentum: the parameters after every step, identical on every rank; and
    a BatchNorm model against one process on the global batches."""
    _reference_elsewhere(ht)
    import torch

    model = _mlp(ht)
    dp = ht.nn.DataParallel(model, optimizer=torch.optim.SGD(model.parameters(), lr=DP_LR, momentum=0.9))
    out = {}
    ht.kernels.reset_kernel_stats()
    for t in range(len(DP_X)):
        loss = dp.train_step(_mse, ht.array(DP_X[t], split=0), ht.array(DP_Y[t], split=0))
        out[f"loss{t}"] = float(loss)
        _params(model, f"step{t}", out)
    out["port:collectives"] = {k: v["calls"] for k, v in ht.kernels.COLLECTIVES.items()}
    out["port:rank:lshape"] = ht.array(DP_X[0], split=0).lshape[0]
    out["port:bn_close"] = _global_batchnorm_matches_one_process(ht)
    return out


def _global_batchnorm_matches_one_process(ht) -> bool:
    """A BatchNorm model trained over the ranks' uneven shards equals the
    same model trained in this process on the global batches."""
    import torch

    dev = ht.get_device().torch_device
    torch.manual_seed(0)
    make = lambda: torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.BatchNorm1d(4), torch.nn.Linear(4, 1))  # noqa: E731
    a, b = make().to(dev), make().to(dev)
    b.load_state_dict(a.state_dict())
    dp = ht.nn.DataParallel(a, optimizer=torch.optim.SGD(a.parameters(), lr=0.1))
    opt = torch.optim.SGD(b.parameters(), lr=0.1)
    for t in range(3):
        dp.train_step(_mse, ht.array(DP_X[t], split=0), ht.array(DP_Y[t], split=0))
        opt.zero_grad()
        _mse(b(torch.as_tensor(DP_X[t], device=dev)), torch.as_tensor(DP_Y[t], device=dev)).backward()
        opt.step()
    sa, sb = dp.module.state_dict(), b.state_dict()
    return all(torch.allclose(sa[k].double(), sb[k].double(), rtol=1e-4, atol=1e-5) for k in sb)


def case_daso(ht):
    """DASO on a (2 x 2) mesh, float32 on the wire, every group on its own
    rows: the replicas' average after every step, the losses and the
    schedule fields; and this rank's gap to the other group's replica."""
    _reference_elsewhere(ht)
    import torch

    dev = ht.get_device().torch_device
    model = _mlp(ht)
    mesh = ht.parallel.make_hierarchical_mesh(n_slow=2)
    daso = ht.optim.DASO(torch.optim.SGD(model.parameters(), lr=DASO_LR), total_epochs=DASO_EPOCHS, warmup_epochs=1,
                         cooldown_epochs=1, downcast_type=torch.float32)
    model = daso.init(model, mesh)

    def loss_fn(m, xb, yb):
        return _mse(m(xb), yb)

    out, gaps = {}, []
    for epoch in range(DASO_EPOCHS):
        for b in range(DASO_BATCHES):
            i = epoch * DASO_BATCHES + b
            model, loss = daso.step(loss_fn, model, torch.as_tensor(DASO_X[i], device=dev),
                                    torch.as_tensor(DASO_Y[i], device=dev))
            out[f"e{epoch}b{b}:loss"] = float(loss)
            out[f"e{epoch}b{b}:schedule"] = (daso.global_skip, daso.batches_to_wait, daso.epoch)
            for name, p in daso.consolidated_params(model).items():
                out[f"e{epoch}b{b}:{name}"] = p.cpu().numpy()
            w = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
            other = ht.nn.data_parallel.group_allreduce(w * (1.0 if daso._group == 0 else -1.0), daso._slow)
            gaps.append(float(other.abs().max()))
        daso.epoch_loss_logic(1.0 / (epoch + 1.0))
    out["port:gaps"] = gaps
    return out


def _grads_of(ht, fn, arrays, comm):
    """(out, dq, dk, dv) of ``(fn(q, k, v).larray ** 2).sum()`` summed over
    the ranks, each rank holding its rows (split 0) of the global arrays."""
    import torch

    dev = ht.get_device().torch_device
    ts = []
    for a in arrays:
        off, lsh, _ = comm.chunk(a.shape, 0)
        ts.append(torch.as_tensor(a[off : off + lsh[0]], device=dev).requires_grad_(True))
    ds = [ht.DNDarray(t, gshape=a.shape, split=0, comm=comm) for t, a in zip(ts, arrays)]
    out = fn(*ds)
    (out.larray ** 2).sum().backward()
    return (out,) + tuple(ht.DNDarray(t.grad, gshape=a.shape, split=0, comm=comm) for t, a in zip(ts, arrays))


def case_attention_grad(ht):
    """The gradients of ring and Ulysses attention with the sequence split
    over the ranks (a length and a head count the ranks do not divide, full
    and causal), and the collectives of one backward pass."""
    _reference_elsewhere(ht)
    comm = ht.get_comm()
    par = ht.parallel
    out = {}
    for n, qkv in ATTG2.items():
        for causal in (False, True):
            res = _grads_of(ht, lambda q, k, v: par.ring_attention(q, k, v, comm, causal=causal), qkv, comm)
            for name, r in zip(("out", "dq", "dk", "dv"), res):
                out[f"ring:{n}:{causal}:{name}"] = r
    for n, qkv in ATTG3.items():
        for causal in (False, True):
            res = _grads_of(ht, lambda q, k, v: par.ulysses_attention(q, k, v, comm, causal=causal), qkv, comm)
            for name, r in zip(("out", "dq", "dk", "dv"), res):
                out[f"ulysses:{n}:{causal}:{name}"] = r
    for name, fn, qkv in (("ring", par.ring_attention, ATTG2[23]), ("ulysses", par.ulysses_attention, ATTG3[23])):
        import torch

        ts = [ht.DNDarray(torch.as_tensor(a[comm.chunk(a.shape, 0)[2]]).requires_grad_(True), gshape=a.shape,
                          split=0, comm=comm) for a in qkv]
        o = fn(*ts, comm, causal=True)
        ht.kernels.reset_kernel_stats()
        (o.larray ** 2).sum().backward()
        out[f"port:{name}_backward_collectives"] = {k: v["calls"] for k, v in ht.kernels.COLLECTIVES.items()}
    return out


def case_dryrun(ht):
    """The entry module's per-rank dry-run body: KMeans (2 iterations of a
    random init), the TSQR residual, ring_map, halo_exchange, ring and
    Ulysses attention on lengths the ranks do not divide, DASO's diverge and
    meet on a (2 x 2) mesh. halo_exchange's values are held against
    heat_tpu here; KMeans' random init, ring_map and the attentions are the
    ``kmeans`` and ``parallel`` cases'."""
    _reference_elsewhere(ht)
    from heat_tpu_torch.entry import dryrun_body

    res = dryrun_body(ht)
    out = {"halo": res["halo"]}
    out.update({"port:centers": res["centers"], "port:ring_map": res["ring_map"], "port:qr_residual": res["qr_residual"],
                "port:daso_gaps": res["daso_gaps"], "port:daso_final": res["daso_final"]})
    return out


# ------------------------------------------------- frame, StreamingGroupBy, resilience
FR_N = 2003  # rows: 501, 501, 501, 500 on 4 ranks
FR_KEY = _rng(50).integers(0, 500, size=FR_N).astype(np.int32)  # uniform keys
FR_G = int(np.unique(FR_KEY).size)  # the distinct keys
FR_X = _rng(51).normal(size=FR_N).astype(np.float32)
FR_I = _rng(52).integers(-50, 50, size=FR_N).astype(np.int32)
FR_RK = _rng(53).permutation(1000)[:500].astype(np.int32)  # unique right keys, half of them in FR_KEY's range
FR_RV = _rng(54).normal(size=500).astype(np.float64)
CK_A = _rng(55).normal(size=(37, 6)).astype(np.float32)


def _balanced(frame):
    """Every column of a frame in the ceil-div layout (range mode's shares
    differ from heat_tpu's, C6; its values and order do not)."""
    return {name: frame[name].balance_() for name in frame.columns}


def case_frame(ht):
    """Frame verbs across the ranks: hash-mode groupby (heat_tpu's layout),
    range-mode groupby (values and order; for the port also each rank's
    groups), value_counts, inner and left joins in both modes, filter, the
    grouped quantile (for the port: within the KLL bound of numpy's) and a
    StreamingGroupBy over split chunks, with SHUFFLE_STATS/MOVE_STATS deltas;
    for the port also the collectives of a groupby."""
    f = ht.Frame({"k": FR_KEY, "x": FR_X, "i": FR_I})
    shuffles = lambda: dict(ht.SHUFFLE_STATS)  # noqa: E731
    out = {}
    s0, m0 = shuffles(), dict(ht.MOVE_STATS)
    spec = ["sum", "mean", "min", "max", "count", "std"]
    h, coll = _collectives(ht, lambda: f.groupby("k", mode="hash").agg(spec))
    out.update({f"hash:{n}": h[n] for n in h.columns})
    r = f.groupby("k").agg(spec)
    if is_port(ht):
        comm = ht.get_comm()
        out["port:groupby_collectives"] = coll["calls"]
        out["port:range_lcounts"] = r["k"].lcounts
        out["port:range_bound"] = 2 * FR_G // comm.size + 32
    out.update({f"range:{n}": c for n, c in _balanced(r).items()})
    out.update({f"counts:{n}": c for n, c in _balanced(f.value_counts("i")).items()})
    out["counts_hash"] = f.value_counts("i", mode="hash")["count"]
    right = ht.Frame({"k": FR_RK, "v": FR_RV})
    for how in ("inner", "left"):
        jh = f.join(right, on="k", how=how, mode="hash")
        out.update({f"join:{how}:hash:{n}": jh[n] for n in jh.columns})
        out.update({f"join:{how}:range:{n}": c for n, c in _balanced(f.join(right, on="k", how=how)).items()})
    sub = f.filter(f["x"] > 0.5)
    out.update({f"filter:{n}": sub[n] for n in sub.columns})
    out["filter_groupby"] = sub.groupby("k", mode="hash").sum()["x"]
    out["shuffle_stats"] = {k: ht.SHUFFLE_STATS[k] - s0[k] for k in s0}
    out["move_stats"] = {k: ht.MOVE_STATS[k] - m0[k] for k in ("ragged_moves", "bucket_moves")}
    sg = ht.stream.StreamingGroupBy(("sum", "mean", "std", "count", "min", "max"), capacity=1024)
    for lo in range(0, FR_N, 300):
        sg.update(ht.array(FR_KEY[lo : lo + 300], split=0), ht.array(FR_X[lo : lo + 300], split=0))
    m1 = dict(ht.MOVE_STATS)
    res = sg.result()
    out.update({f"streaming:{n}": v for n, v in res.items()})
    out["streaming_n"] = sg.n
    if is_port(ht):
        out["port:streaming_merge"] = {k: ht.MOVE_STATS[k] - m1[k] for k in ("tree_merges", "tree_merge_rounds")}
        small = ht.stream.StreamingGroupBy(("sum",), capacity=FR_G - 1)
        small.update(ht.array(FR_KEY, split=0), ht.array(FR_X, split=0))
        out["port:overflow"] = attempt(small.result)
        q = ht.Frame({"g": FR_KEY % 4, "x": FR_X}).groupby("g").quantile(0.5, k=64, levels=6)
        got = q["x"].numpy()
        ok = []
        for g in range(4):
            sx = np.sort(FR_X[FR_KEY % 4 == g])
            lo, hi = np.searchsorted(sx, got[g], "left"), np.searchsorted(sx, got[g], "right")
            target = 0.5 * (sx.size - 1)
            ok.append(max(0.0, lo - target, target - hi) / sx.size <= (3 + 2) / (2 * 64))
        out["port:quantile_within_bound"] = ok
        out["port:quantile_keys"] = q["g"].numpy()
    return out


def case_resilience(ht):
    """Checkpoints across world sizes (saved by all ranks, loaded by one
    process and the reverse; for the port also the shard files' bytes),
    fingerprints of split and replicated arrays, validate and health_check
    of a ragged array, and (the port) a divergence fault entered on rank 2
    alone, raised as the same DivergenceError on every rank."""
    rz = ht.resilience
    comm = ht.get_comm()
    d = os.path.join(_case_dir(), "ckpt4")
    out = {}
    for split in (0, 1, None):
        x = ht.array(CK_A, split=split)
        rz.save_checkpoint(x, d)
        out[f"load:{split}"] = rz.load_checkpoint(d)
        out[f"fp:{split}"] = rz.fingerprint(x).groups
    rag = ht.array(CK_A, split=0)
    rag.redistribute_(target_map=_tmap([20, 0, 10, 7][: comm.size] if comm.size == 4 else [37], CK_A.shape, 0))
    out["ragged_health"] = rag.health_check(check_values=True) is rag
    if is_port(ht):
        out["port:ragged_kept"] = rag.lcounts  # heat_tpu's value scan rebalances the array; the port's reads it as it lies
    out["ragged_fp"] = rz.fingerprint(rag).groups
    if is_port(ht):
        x = ht.array(CK_A, split=0)
        rz.save_checkpoint(x, d, checksum="sha256")
        names = sorted(n for n in os.listdir(d) if n.startswith("shard_"))
        out["port:ckpt_files"] = {n: open(os.path.join(d, n), "rb").read() for n in names}
        out["port:ckpt_manifest"] = open(os.path.join(d, "manifest.json"), "rb").read()
        one = rz.load_checkpoint(d, comm=ht.SELF)  # the 4-rank save, loaded by one process
        out["port:loaded_alone"] = bool(np.array_equal(one.numpy(), CK_A)) and one.comm is ht.SELF
        d1 = os.path.join(_case_dir(), "ckpt1")
        if comm.rank == 0:
            rz.save_checkpoint(ht.array(CK_A, split=0, comm=ht.SELF), d1)  # a one-process save
        comm.barrier()
        back = rz.load_checkpoint(d1)
        out["port:one_to_all"] = (np.asarray(back.lshape_map), bool(np.array_equal(back.numpy(), CK_A)))
        rep = ht.array(CK_A[:5])
        sched = [("guard.shard", 1, "divergence")] if comm.rank == 2 else []
        with rz.FaultSchedule(sched) as fs:
            err = attempt(lambda: rz.check_divergence(rep))
        out["port:divergence"] = (err.type, err.message) if isinstance(err, Raised) else None
        out["port:rank:injected"] = [(i.site, i.kind) for i in fs.injected]
    return out


# ------------------------------------------------ supervision and serving
DG_X = _rng(80).normal(size=(10, 3)).astype(np.float32)
DG_Z = _rng(81).integers(-50, 50, size=(4, 9)).astype(np.int32)
SV_X, _ = _blobs(82, 96, 3, 3)
SV_TRACE = [(int(n), "km.predict" if i % 4 == 0 else "knn.predict")
            for i, n in enumerate(_rng(83).integers(1, 6, size=24))]
SV_PAYLOADS = [_rng(84 + i).normal(size=(n, 3)).astype(np.float32) * 5 for i, (n, _) in enumerate(SV_TRACE)]


def _degrade_record(ht, out, tag, arrays, comm):
    """Each moved array's layout (the same on every rank), and for the port
    this rank's membership, rows and (on members) the gathered values."""
    for i, a in enumerate(arrays):
        out[f"{tag}:{i}"] = (a.dtype.__name__, tuple(int(s) for s in a.gshape), a.split, np.asarray(a.lshape_map))
        if is_port(ht):
            member = comm.is_member
            out[f"port:rank:{tag}:{i}"] = (member, a._raw.cpu().numpy(), a.numpy() if member else None)
        else:
            out[f"ref:{tag}:{i}"] = np.asarray(a.numpy())


def case_degrade(ht):
    """Rank (device) 2 marked: shrink to three, then grow back to four; then
    ranks 2 and 3 marked: shrink to two, 3 healed: grow to three (a plain new
    group on the port), 2 healed: grow to four. A split-0, a split-1, a
    replicated and a ragged array move along each time. On the port, rank 2
    marked once more: the shrink reuses the group of the first one."""
    rz = ht.resilience
    comm = ht.get_comm()
    arrays = [ht.array(DG_X, split=0), ht.array(DG_Z, split=1), ht.array(DG_X[:3]),
              _ragged(ht, DG_X, 0, [1, 5, 0, 4] if comm.size == 4 else [10])]
    out = {}
    if is_port(ht):  # the unions every rank agrees on (heat_tpu's are per process: one process there)
        out["port:replicated_ids"] = sorted(ht.replicated_ids({comm.rank, 10 + comm.rank}))
        out["port:replicated_frame"] = ht.replicated_frame(np.array([comm.rank, -comm.rank], np.int64))
    try:
        rz.mark_unhealthy(2)
        small, moved = rz.shrink_to_healthy(comm, arrays)
        out["sizes:shrink"] = small.size
        _degrade_record(ht, out, "shrink", moved, small)
        rz.clear_unhealthy(2)
        big, back = rz.grow_to_healthy(small, moved, base=comm)
        out["sizes:grow"] = big.size
        _degrade_record(ht, out, "grow", back, big)
        rz.mark_unhealthy(2)
        rz.mark_unhealthy(3)
        two, moved = rz.shrink_to_healthy(big, back)
        rz.clear_unhealthy(3)
        three, moved = rz.grow_to_healthy(two, moved, base=comm)
        out["sizes:leg2"] = (two.size, three.size)
        _degrade_record(ht, out, "leg2", moved, three)
        rz.clear_unhealthy(2)
        four, moved = rz.grow_to_healthy(three, moved, base=comm)
        _degrade_record(ht, out, "leg2_back", moved, four)
        if is_port(ht):  # rank 2 out again: the group built for the first shrink comes back, and no new one
            from torch.distributed import distributed_c10d

            held = len(distributed_c10d._world.pg_names)
            rz.mark_unhealthy(2)
            again, _ = rz.shrink_to_healthy(four, [])
            out["port:group_reused"] = bool(again.ranks == small.ranks and again._group is small._group)
            out["port:groups_added"] = len(distributed_c10d._world.pg_names) - held
    finally:
        rz.clear_unhealthy()
    return out


def case_supervisor(ht):
    """A supervised KMeans fit (checkpoint every step, 3 iterations a step)
    that loses a device at step 2 (the FaultSchedule's draw picks rank 1):
    it shrinks onto the three survivors, restores the last checkpoint and
    finishes there; the lost rank detaches (the port)."""
    rz = ht.resilience
    comm = ht.get_comm()
    x = ht.array(SV_X, split=0)
    clean = ht.cluster.KMeans(3, init=ht.array(SV_X[:3]), max_iter=12, tol=None).fit(x)
    out = {"clean": clean.cluster_centers_}
    d = os.path.join(_case_dir(), "supervised")
    before = dict(rz.RECOVERY_STATS)
    sup = rz.Supervisor(d, rz.CheckpointSchedule(every_steps=1))
    try:
        with rz.FaultSchedule([("supervisor.step", 3, "device_loss")]) as fs:
            km = ht.cluster.KMeans(3, init=ht.array(SV_X[:3]), max_iter=12, tol=None).fit(x, supervisor=sup,
                                                                                          block_iters=3)
        lost = sorted(rz.unhealthy_devices())
    finally:
        rz.clear_unhealthy()
        ht.use_comm(comm)
    counters = {k: rz.RECOVERY_STATS[k] - before[k] for k in before if k != "recovery_seconds_total"}
    out["lost"] = lost
    out["injected"] = [(i.site, i.kind) for i in fs.injected]
    if is_port(ht):
        res = km.supervisor_result_
        out["port:rank:detached"] = res.detached
        out["port:rank:counters"] = counters
        out["port:rank:fit"] = None if res.detached else (km.cluster_centers_.numpy(), km.n_iter_, km.inertia_,
                                                          res.comm.size, km.labels_.numpy())
    else:
        out["ref:counters"] = counters
        out["ref:fit"] = (np.asarray(km.cluster_centers_.numpy()), km.n_iter_, km.inertia_, sup._comm.size,
                          np.asarray(km.labels_.numpy()))
    return out


def case_serve(ht):
    """A ServeService of a KMeans and a kNN classifier with the replicated
    tick armed (every rank submits the same trace), one device loss at the
    third batch dispatch: every request is answered exactly once, with the
    models' rows, or (the port, on the lost rank) a DegradeError."""
    rz = ht.resilience
    comm = ht.get_comm()
    x = ht.array(SV_X, split=0)
    km = ht.cluster.KMeans(3, init=ht.array(SV_X[:3]), max_iter=5, tol=None).fit(x)
    knn = ht.classification.KNeighborsClassifier(3).fit(x, km.labels_)
    want = []  # each endpoint's predict of all its requests' rows at once, cut back into requests
    for ep, model in (("km.predict", km), ("knn.predict", knn)):
        rows = [p for (_, e), p in zip(SV_TRACE, SV_PAYLOADS) if e == ep]
        got = np.asarray(model.predict(ht.array(np.concatenate(rows))).numpy())
        want += list(zip([i for i, (_, e) in enumerate(SV_TRACE) if e == ep], np.split(got, np.cumsum([len(r) for r in rows])[:-1])))
    want = [w for _, w in sorted(want, key=lambda t: t[0])]
    before = dict(ht.serve.SERVE_STATS)
    svc = ht.serve.ServeService(ht.serve.BucketPolicy(max_batch=8, max_latency_ms=1.0), tick_ms=1.0)
    answers = []
    try:
        svc.register_model("km", km)
        svc.register_model("knn", knn)
        with rz.FaultSchedule([("serve.dispatch", 3, "device_loss")]) as fs:
            reqs = [svc.submit(ep, p) for (_, ep), p in zip(SV_TRACE, SV_PAYLOADS)]
            svc.drain(timeout=120)
        size_after = ht.get_comm().size
        member = ht.get_comm().is_member if is_port(ht) else True
        for r in reqs:
            try:
                answers.append(("rows", np.asarray(r.result(timeout=60))))
            except Exception as e:  # the test holds which error each package answered with
                answers.append((type(e).__name__, str(e)))
    finally:
        svc.close(timeout=60)
        rz.clear_unhealthy()
        ht.use_comm(comm)
    stats = {k: ht.serve.SERVE_STATS[k] - before[k] for k in ("requests", "batches", "shrinks", "redispatched",
                                                                  "errors")}
    out = {"want": want, "lost": [(i.site, i.kind) for i in fs.injected], "answered_once": [r.answers for r in reqs]}
    if is_port(ht):
        out["port:rank:answers"] = answers
        out["port:rank:member"] = member
        out["port:rank:size_after"] = size_after
        out["port:rank:stats"] = stats
    else:
        out["ref:answers"] = answers
        out["ref:size_after"] = size_after
    return out


def case_lazy_lockstep(ht):
    """Lazy chains over split None/0/1 (a split-axis reduction, a cumsum, the
    standardize chain, the decorator) inside the lockstep sanitizer, whose
    check passes; FUSE_STATS as heat_tpu counts them. For the port also: a
    lockstep_divergence scheduled on rank 1 alone makes the next check
    raise LockstepError on every rank."""
    out = {}
    chains = {
        "shift_sum": lambda a: ht.sum((a - 1.25) * 2.75, axis=0),
        "standardize": lambda a: (a - ht.mean(a, axis=0)) / (ht.std(a, axis=0) + 1.0),
        "cumsum": lambda a: ht.cumsum(a * 3.5, axis=0) - 0.5,
        "elementwise": lambda a: ht.exp(-ht.abs(a)) * 2.375 + 1.625,
        "cmp": lambda a: (a > 0.25) * a + ht.sqrt(ht.abs(a)) / 3.0,
    }
    with ht.analysis.lockstep(check_at_exit=False) as ls:
        for split in (None, 0, 1):
            x = ht.array(A95, split=split)
            for name, chain in chains.items():
                ht.reset_fuse_stats()
                with ht.lazy():
                    got = chain(x)
                out[f"{name}_{split}"] = got
                out[f"{name}_{split}_stats"] = dict(ht.FUSE_STATS)
            ht.reset_fuse_stats()
            out[f"fused_{split}"] = ht.fuse(chains["elementwise"])(x)
            out[f"fused_{split}_stats"] = dict(ht.FUSE_STATS)
        ls.check("lazy chains")
    if is_port(ht):
        out["port:lockstep_divergences"] = ht.LOCKSTEP_STATS["divergences"]
        schedule = [("collective.allgather", 1, "lockstep_divergence")] if ht.get_comm().rank == 1 else []
        with ht.analysis.lockstep(check_at_exit=False) as ls:
            with ht.resilience.FaultSchedule(schedule):
                ht.core.communication.ragged_process_allgather(np.arange(3), 0)
            err = attempt(lambda: ls.check("after the dropped event"))
        out["port:lockstep_error"] = getattr(err, "type", None)
    return out


def case_host_events(ht):
    """Host fetches the sanitizer counts (``host_syncs``) per call, as
    heat_tpu counts them: gathers, scalars, and the scans' fetches."""
    x = ht.array(A95, split=0)
    calls = {
        "numpy": lambda: x.numpy(),
        "item": lambda: ht.sum(x).item(),
        "bool": lambda: bool(ht.sum(x) > 0),
        "float": lambda: float(ht.max(x)),
        "nonzero": lambda: ht.nonzero(x > 0.5),
        "unique": lambda: ht.unique(ht.array(np.round(A95[:, 0]), split=0)),
    }
    out = {}
    for name, fn in calls.items():
        r = ht.analysis.Region(name)
        fn()
        out[f"host_syncs_{name}"] = r.host_syncs
    return out


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_") and callable(fn)
}
# cases whose reference is the port itself at world size 1 (heat_tpu has no counterpart to compare)
PORT_ONLY = {"environment", "not_implemented"}
# cases that lose a rank: held against heat_tpu by tests of their own (a rank outside the shrunken group holds no
# rows, and the survivors' group ranks are not their global ranks)
SHRINKING = {"degrade", "supervisor", "serve"}




def run_cases(ht, names, port: bool):
    out = {}
    for name in names:
        try:
            out[name] = {k: pack(v, port) for k, v in CASES[name](ht).items()}
        except Exception:
            out[name] = {"__error__": traceback.format_exc()}
            print(f"case {name} failed:\n{out[name]['__error__']}", file=sys.stderr, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True, help="file for the group's FileStore")
    ap.add_argument("--out", required=True, help="directory for rank{R}.pkl")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    import heat_tpu_torch as ht

    if args.backend == "gloo":
        ht.use_device("cpu")
    ht.init_distributed(backend=args.backend, init_method=f"file://{args.store}", world_size=args.world,
                        rank=args.rank, local_rank=args.rank, timeout=180)
    global CASE_DIR
    CASE_DIR = args.out
    results = run_cases(ht, args.cases.split(","), port=True)
    ht.get_comm().barrier()
    with open(os.path.join(args.out, f".rank{args.rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)
    os.replace(os.path.join(args.out, f".rank{args.rank}.pkl"), os.path.join(args.out, f"rank{args.rank}.pkl"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
