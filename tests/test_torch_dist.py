"""heat_tpu_torch across ranks, against heat_tpu on a device mesh of the
same size, on the CPU.

One group of four processes (``torch.distributed`` over gloo, started
through ``ht.init_distributed``, ``torch.set_num_threads(1)``) runs every
case of ``tests/test_torch_dist_worker.py`` on the port; the test process
runs the same case code on ``heat_tpu`` under
``comm_context(MeshCommunication(devices=jax.devices()[:4]))``. The group
runs once per test session: the first pytest worker to need it spawns it,
under a file lock, and the others read its results. Every rank's result is
held against heat_tpu's: values, dtype, ``gshape``, ``split``,
``lshape_map``, and the rank's ``larray`` against heat_tpu's chunk of the
same rank; replicated results must be bit-identical on every rank.

Tolerances: bool, integer and index results exact; float results rtol
1e-5 / atol 1e-6 (reductions across ranks add in another order than one
device's XLA program, and XLA's and torch's transcendental functions
may round differently in the last bits); QR factors compared after
making R's diagonal non-negative, rtol 1e-4 / atol 1e-5 (TSQR's second
factorization rotates by a different orthogonal matrix on each package),
and the same for the iterative solvers, the SVDs (singular pairs with a
fixed sign) and spectral clustering's Laplacians: Krylov and singular
vectors built from float32 products summed in another order drift by a
few 1e-6 in entries of size 1e-3 to 1. The attentions (case ``parallel``)
atol 2e-5: an output row is a convex combination of rows of v from an
online softmax over N <= 24 keys folded in another order (P blocks
against one), a few float32 roundings of sums of N terms of size <= 4,
N u max|v| = 24 * 2^-24 * 4 = 6e-6.

Ragged results are held to heat_tpu's layout (``lshape_map``, ``lcounts``)
and the rank's rows as they lie; counter deltas (``LAYOUT_STATS`` and
``MOVE_STATS``) must equal heat_tpu's.

A case whose reference is the port itself (``PORT_ONLY``: the port's own
bookkeeping) is not held against heat_tpu; the random draws are held
against heat_tpu and, as every world size must give the same global
draws, against the port at world size 1 in the test process too.
heat_tpu is imported only inside the functions that need it, so the
``gpu``-marked NCCL test also runs where JAX is not installed
(``--noconftest``).
"""
import fcntl
import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from tests import test_torch_dist_worker as W

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(W.__file__).resolve()
WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
QR_RTOL, QR_ATOL = 1e-4, 1e-5
ATTN_ATOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-4
GNB_ATOL = 1e-4
GROUP_TIMEOUT = 420  # seconds for the whole group, start to exit
_RUN_ID = os.environ.get("PYTEST_XDIST_TESTRUNUID") or uuid.uuid4().hex

HT_CASES = sorted(set(W.CASES) - W.PORT_ONLY - W.SHRINKING)


# ------------------------------------------------------------ the group
def _spawn(world: int, backend: str, names, d: Path, timeout: float) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, str(WORKER), "--world", str(world), "--store", str(d / "store"), "--out", str(d),
           "--backend", backend, "--cases", ",".join(names)]
    procs = [
        subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=env, cwd=str(REPO))
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        return {"__error__": f"the {backend} group of {world} did not finish within {timeout} s"}
    ranks = []
    for r, p in enumerate(procs):
        f = d / f"rank{r}.pkl"
        if p.returncode != 0 or not f.exists():
            return {"__error__": f"rank {r} exited with {p.returncode}:\n{logs[r][-6000:]}"}
        with open(f, "rb") as fh:
            ranks.append(pickle.load(fh))
    return {"ranks": ranks, "logs": logs}


def run_group(world: int, backend: str = "gloo", names=None, timeout: float = GROUP_TIMEOUT) -> list:
    """Every rank's results, ``[rank][case][name]``, from one group of
    ``world`` processes; shared by the pytest workers of one run."""
    names = list(W.CASES) if names is None else list(names)
    tag = hashlib.sha256(f"{_RUN_ID}:{world}:{backend}:{','.join(names)}".encode()).hexdigest()[:16]
    d = Path(tempfile.gettempdir()) / f"heat_tpu_torch_dist_{tag}"
    d.mkdir(exist_ok=True)
    done = d / "results.pkl"
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                res = _spawn(world, backend, names, d, timeout)
                with open(d / "results.tmp", "wb") as fh:
                    pickle.dump(res, fh)
                os.replace(d / "results.tmp", done)
            with open(done, "rb") as fh:
                res = pickle.load(fh)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if "__error__" in res:
        pytest.fail(res["__error__"])
    return res["ranks"]


@pytest.fixture(scope="module")
def group():
    return run_group(WORLD)


def _case(group, name):
    per_rank = [rank[name] for rank in group]
    for r, res in enumerate(per_rank):
        assert "__error__" not in res, f"rank {r}:\n{res['__error__']}"
    return per_rank


# ------------------------------------------------------- the references
def heat_tpu_results(name: str, world: int = WORLD) -> dict:
    import jax

    import heat_tpu as htj
    from heat_tpu.core.communication import MeshCommunication, comm_context

    case = REFERENCES.get(name, W.CASES[name])
    with comm_context(MeshCommunication(devices=jax.devices()[:world])):
        return {k: W.pack(v, port=False) for k, v in case(htj).items()}


# heat_tpu's side of the training cases, which needs jax, flax and optax (the worker imports none of them)
def _flax_mlp():
    import flax.linen as fnn

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Dense(16)(x)
            x = fnn.tanh(x)
            return fnn.Dense(1)(x)

    return MLP()


def _torch_layout(variables, prefix, out):
    """flax MLP parameters under the port's names and layouts."""
    p = {k: {f: np.asarray(v) for f, v in d.items()} for k, d in variables["params"].items()}
    for i, name in ((0, "0"), (1, "2")):
        out[f"{prefix}:{name}.weight"] = p[f"Dense_{i}"]["kernel"].T
        out[f"{prefix}:{name}.bias"] = p[f"Dense_{i}"]["bias"]


def _ref_data_parallel(ht):
    import jax.numpy as jnp
    import optax

    dp = ht.nn.DataParallel(_flax_mlp(), optimizer=optax.sgd(W.DP_LR, momentum=0.9))
    dp.init(jnp.zeros((1, 8)))
    dp.load_state_dict({f"params['params']['{layer}']['{f}']": v for layer, d in W.DP_TREE["params"].items()
                        for f, v in d.items()})
    out = {}
    for t in range(len(W.DP_X)):
        loss = dp.train_step(lambda pred, y: jnp.mean((pred - y) ** 2), ht.array(W.DP_X[t], split=0),
                             ht.array(W.DP_Y[t], split=0))
        out[f"loss{t}"] = float(loss)
        _torch_layout(dp.params, f"step{t}", out)
    return out


def _ref_daso(ht):
    import jax
    import jax.numpy as jnp
    import optax

    from heat_tpu.parallel.mesh import make_hierarchical_mesh

    model = _flax_mlp()
    mesh = make_hierarchical_mesh(n_slow=2, devices=ht.get_comm().mesh.devices.ravel().tolist())
    daso = ht.optim.DASO(optax.sgd(W.DASO_LR), total_epochs=W.DASO_EPOCHS, warmup_epochs=1, cooldown_epochs=1,
                         downcast_type=jnp.float32)
    params = daso.init(jax.tree_util.tree_map(jnp.asarray, W.DP_TREE), mesh)

    def fn(p, xb, yb):
        return jax.value_and_grad(lambda q: jnp.mean((model.apply(q, xb) - yb) ** 2))(p)

    out = {}
    for epoch in range(W.DASO_EPOCHS):
        for b in range(W.DASO_BATCHES):
            i = epoch * W.DASO_BATCHES + b
            params, loss = daso.step(fn, params, jnp.asarray(W.DASO_X[i]), jnp.asarray(W.DASO_Y[i]))
            out[f"e{epoch}b{b}:loss"] = float(loss)
            out[f"e{epoch}b{b}:schedule"] = (daso.global_skip, daso.batches_to_wait, daso.epoch)
            _torch_layout(daso.consolidated_params(params), f"e{epoch}b{b}", out)
        daso.epoch_loss_logic(1.0 / (epoch + 1.0))
    return out


def _ref_attention_grad(ht):
    """heat_tpu's dense attention and its gradients (jax.grad) on the global arrays: ring and Ulysses attention are
    exact attention, so are their gradients (tests/test_torch_attention_grad.py holds the port's against heat_tpu's
    own ring and Ulysses gradients at world size 1)."""
    import jax
    import jax.numpy as jnp

    from heat_tpu.parallel.ring_attention import attention

    def heads_first(a):
        return jnp.moveaxis(a, 1, 0)

    out = {}
    for kind, inputs in (("ring", W.ATTG2), ("ulysses", W.ATTG3)):
        for n, qkv in inputs.items():
            for causal in (False, True):
                if kind == "ring":
                    f = lambda *a: attention(*a, causal=causal)  # noqa: E731
                else:  # (N, H, D): heads first for the dense oracle, and back
                    f = lambda *a: heads_first(attention(*(heads_first(t) for t in a), causal=causal))  # noqa: E731
                o, grads = jax.jit(lambda *a, f=f: (f(*a), jax.grad(lambda *b: (f(*b) ** 2).sum(), argnums=(0, 1, 2))(
                    *a)))(*(jnp.asarray(a) for a in qkv))
                for name, r in zip(("out", "dq", "dk", "dv"), (o,) + tuple(grads)):
                    out[f"{kind}:{n}:{causal}:{name}"] = ht.array(np.asarray(r), split=0)
    return out


def _ref_dryrun(ht):
    """__graft_entry__.dryrun_multichip's halo_exchange on the same data."""
    from heat_tpu.parallel import halo_exchange

    comm = ht.get_comm()
    x = ht.array(np.random.default_rng(0).normal(size=(16 * comm.size, 8)).astype(np.float32), split=0)
    return {"halo": ht.array(np.asarray(halo_exchange(x.larray, 2, comm)), split=0)}


REFERENCES = {"data_parallel": _ref_data_parallel, "daso": _ref_daso, "attention_grad": _ref_attention_grad,
              "dryrun": _ref_dryrun}


def port_world1_results(name: str) -> dict:
    htt.use_device("cpu")
    try:
        return W.run_cases(htt, [name], port=True)[name]
    finally:
        htt.use_device(None)


def _chunk(glob: np.ndarray, lshape_map: np.ndarray, split, rank: int) -> np.ndarray:
    """Rank ``rank``'s chunk of ``glob`` by ``lshape_map`` (ceil-div)."""
    if split is None:
        return glob
    start = int(lshape_map[:rank, split].sum())
    idx = [slice(None)] * glob.ndim
    idx[split] = slice(start, start + int(lshape_map[rank, split]))
    return glob[tuple(idx)]


def _close(got, want, rtol, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    if want.dtype.kind in "biuO" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN positions")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True, err_msg=what)


def compare(port: dict, ref: dict, rank: int, what: str, rtol=RTOL, atol=ATOL, lshape_map=True, world=WORLD):
    """One packed port result of rank ``rank`` against the packed reference."""
    assert port["kind"] == ref["kind"], f"{what}: {port} vs {ref}"
    kind = ref["kind"]
    meta_only = what.split("/")[-1].startswith("meta:")
    if kind == "array":
        assert port["dtype"] == ref["dtype"], f"{what}: dtype {port['dtype']} vs {ref['dtype']}"
        assert port["gshape"] == ref["gshape"], f"{what}: gshape {port['gshape']} vs {ref['gshape']}"
        assert port["split"] == ref["split"], f"{what}: split {port['split']} vs {ref['split']}"
        # heat_tpu's layout, ragged or ceil-div; against a reference of another world size, the ceil-div one
        lmap = np.asarray(ref["lshape_map"]) if lshape_map else _ceil_div_map(ref["gshape"], ref["split"], world)
        if lshape_map:
            assert port["lcounts"] == ref["lcounts"], f"{what}: lcounts {port['lcounts']} vs {ref['lcounts']}"
            if ref["lcounts"] is None:
                np.testing.assert_array_equal(lmap, _ceil_div_map(ref["gshape"], ref["split"], world),
                                              err_msg=f"{what}: ceil-div lshape_map")
        np.testing.assert_array_equal(port["lshape_map"], lmap, err_msg=f"{what}: lshape_map")
        chunk = _chunk(ref["global"], lmap, ref["split"], rank)
        if meta_only:
            assert port["local"].shape == chunk.shape, what
            return
        _close(port["global"], ref["global"], rtol, atol, f"{what}: global")
        _close(port["local"], chunk, rtol, atol, f"{what}: rank {rank}'s larray")
    elif kind == "seq":
        assert len(port["items"]) == len(ref["items"]), what
        for i, (p, j) in enumerate(zip(port["items"], ref["items"])):
            compare(p, j, rank, f"{what}[{i}]", rtol, atol, lshape_map, world)
    elif kind == "raises":
        assert port["type"] == ref["type"], f"{what}: raised {port['type']} ({port['message']}), want {ref['type']}"
    elif kind in ("scalar", "ndarray"):
        _close(port["value"], ref["value"], rtol, atol, what)
    else:
        assert port["value"] == ref["value"], f"{what}: {port['value']} vs {ref['value']}"


def _ceil_div_map(gshape, split, world):
    out = np.array([list(gshape)] * world, dtype=np.int64).reshape(world, len(gshape))
    if split is not None:
        n = gshape[split]
        block = -(-n // world) if n else 0
        for r in range(world):
            start = min(r * block, n)
            out[r, split] = min(start + block, n) - start
    return out


def _tolerance(case):
    if case == "parallel":
        return RTOL, ATTN_ATOL
    if case == "attention_grad":  # heat_tpu's own tests of these gradients: rtol/atol 2e-4
        return GRAD_RTOL, GRAD_ATOL
    if case == "gaussian_nb":  # E[x²] - mean² of |x| <= ~8 in float32, summed in another order
        return RTOL, GNB_ATOL
    return (QR_RTOL, QR_ATOL) if case in ("qr", "solver", "svd", "spectral") else (RTOL, ATOL)


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("case", HT_CASES)
def test_case_matches_heat_tpu_at_world_size_4(group, case):
    per_rank = _case(group, case)
    ref = heat_tpu_results(case)
    rtol, atol = _tolerance(case)
    for rank, res in enumerate(per_rank):
        assert set(ref) == {k for k in res if not k.startswith("port:")}, case
        for key, want in ref.items():
            compare(res[key], want, rank, f"{case}/{key}", rtol, atol)


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_replicated_results_are_bit_identical_on_every_rank(group, case):
    per_rank = _case(group, case)

    def leaves(v, path):
        if v["kind"] == "seq":
            for i, item in enumerate(v["items"]):
                yield from leaves(item, f"{path}[{i}]")
        elif v["kind"] == "array":
            yield path, v["global"]
            if v["split"] is None:
                yield path + ":local", v["local"]
        elif v["kind"] in ("scalar", "ndarray"):
            yield path, np.asarray(v["value"])

    skip = {"rank", "device", "decision", "collectives_before", "port:fills", "port:chunk_elems"}  # facts of one rank
    for key in per_rank[0]:
        if key in skip or key.startswith(("meta:", "port:rank:")):
            continue
        first = dict(leaves(per_rank[0][key], key))
        for rank, res in enumerate(per_rank[1:], 1):
            for path, val in leaves(res[key], key):
                assert np.array_equal(val, first[path], equal_nan=val.dtype.kind == "f"), f"{case}/{path} on rank {rank}"


def test_empty_shard_layouts_match_heat_tpu(group):
    res = _case(group, "layout")[0]
    assert res["a93_s0"]["lshape_map"].tolist() == [[3, 3], [3, 3], [3, 3], [0, 3]]
    assert res["a33_s0"]["lshape_map"].tolist() == [[1, 3], [1, 3], [1, 3], [0, 3]]
    assert res["a93_s0_to_1"]["lshape_map"].tolist() == [[9, 1], [9, 1], [9, 1], [9, 0]]
    assert res["a95_s1"]["lshape_map"].tolist() == [[9, 2], [9, 2], [9, 1], [9, 0]]
    last = _case(group, "layout")[3]
    assert last["a93_s0"]["local"].shape == (0, 3) and last["a93_s0_to_1"]["local"].shape == (9, 0)


def test_kmeans_fit_runs_one_allreduce_per_iteration_and_gathers_no_x(group):
    """5 iterations and the inertia pass: 6 allreduces of one packed buffer
    of k*f + k + 1 float32 values each, and nothing else, on every rank."""
    k, f = 3, 5
    for rank, res in enumerate(_case(group, "kmeans")):
        coll = res["port:collectives"]["value"]
        assert coll == {"allreduce": {"calls": 6, "bytes": 6 * (k * f + k + 1) * 4}}, (rank, coll)
        assert res["n_iter"]["value"] == 5


def test_matvec_over_a_split_contracted_axis_gathers_nothing(group):
    """A split-1 matrix times a split-0 vector (lstsq's Qᵀb across ranks)
    is one product of the chunks and one allreduce, on every rank: neither
    operand is gathered."""
    for rank, res in enumerate(_case(group, "linalg")):
        assert res["port:matvec_collectives"]["value"] == {"allreduce": 1}, rank


def _share_bytes(n: int, itemsize: int) -> int:
    """Bytes of the largest ceil-div chunk of n elements of ``itemsize``."""
    return -(-n // WORLD) * itemsize


def test_sort_receives_at_most_three_shares(group):
    """The sample sort of 4001 float32 values: every rank receives at most
    3 times its share of values plus int64 indices, over every collective
    of the sort (samples, bucket sizes, buckets, rebalance)."""
    share = _share_bytes(W.BIG1D.size, 4 + 8)
    for rank, res in enumerate(_case(group, "sort")):
        coll = res["port:sort_collectives"]["value"]
        got = sum(coll["received"].values())
        assert got <= 3 * share, (rank, coll, share)
        assert set(coll["calls"]) <= {"allgather", "alltoall"}, (rank, coll)


def test_percentile_along_the_split_axis_sends_counts_not_rows(group):
    """The selection's bisection: one allreduce of the (T, 1, m) counts per
    key bit (32 for float32), and one of the NaN flags; nothing that grows
    with the rows."""
    # q = 0, 25, 30, 50, 75, 100 at n = 37 sit at positions 0, 9, 10.8, 18, 27, 36: seven distinct ranks
    # (10.8 wants 10 and 11), over 4 columns
    t_n, m = 7, 4
    for rank, res in enumerate(_case(group, "order_stats")):
        coll = res["port:percentile_collectives"]["value"]
        assert set(coll["calls"]) == {"allreduce"}, (rank, coll)
        assert coll["calls"]["allreduce"] == 32 + 1, (rank, coll)
        assert coll["sent"]["allreduce"] == 32 * t_n * m * 8 + m * 4, (rank, coll)  # int64 counts, int32 flags


def test_kmedians_fit_sends_counts_not_rows(group):
    """Per iteration: one allreduce of the (k, f) member counts and one of
    the (2, k, f) bisection counts per key bit (32 for float32); the
    explicit init is replicated, so nothing else moves."""
    k, f, iters = 3, 5, 8
    for rank, res in enumerate(_case(group, "kmedians")):
        coll = res["port:kmedians_collectives"]["value"]
        assert set(coll["calls"]) == {"allreduce"}, (rank, coll)
        assert coll["calls"]["allreduce"] == iters * (1 + 32), (rank, coll)
        assert coll["sent"]["allreduce"] == iters * (k * f * 8 + 32 * 2 * k * f * 8), (rank, coll)


@pytest.mark.parametrize("name", ["vector_norm0", "vector_norm_inf", "vector_norm_ninf", "vector_norm_0",
                                  "vector_norm_3", "vector_norm_kd", "matrix_norm_1", "matrix_norm_m1",
                                  "matrix_norm_inf", "matrix_norm_ninf", "matrix_norm_fro", "trace_s0", "trace_s1",
                                  "dot_00", "dot_0n", "dot_int"])
def test_norms_trace_and_dot_reduce_chunks_with_one_allreduce(group, name):
    """Over the split axis each of these reduces every rank's chunk and
    completes the reduction with allreduces of the reduced shape, never
    gathering the array."""
    for rank, res in enumerate(_case(group, "norms")):
        coll = res[f"port:{name}"]["value"]
        assert set(coll["calls"]) <= {"allreduce"}, (name, rank, coll)
        assert 1 <= coll["calls"].get("allreduce", 0) <= 2, (name, rank, coll)


def test_kmeans_random_inits_agree_across_ranks_and_with_world_size_1(group):
    """heat_tpu's starting rows on every rank and at world size 1 (the
    kmeans case holds them against heat_tpu's too), and the fits from them."""
    per_rank = _case(group, "kmeans")
    alone = port_world1_results("kmeans")
    for init in ("random", "kmeans++"):
        for res in per_rank[1:]:
            np.testing.assert_array_equal(res[f"init0:{init}"]["value"], per_rank[0][f"init0:{init}"]["value"])
            np.testing.assert_array_equal(res[f"init:{init}"]["global"], per_rank[0][f"init:{init}"]["global"])
        # the same rows of z, whose standardization across ranks rounds otherwise than at world size 1
        np.testing.assert_allclose(per_rank[0][f"init0:{init}"]["value"], alone[f"init0:{init}"]["value"], rtol=RTOL,
                                   atol=ATOL)
        assert per_rank[0][f"init:{init}"]["gshape"] == (3, 5)
        np.testing.assert_allclose(per_rank[0][f"init:{init}"]["global"], alone[f"init:{init}"]["global"], rtol=RTOL,
                                   atol=ATOL)


# cases held against the port at world size 1 as well: port-only bookkeeping, and the draws, which must
# give the same global arrays at every world size
WORLD1_CASES = sorted((W.PORT_ONLY | {"random"}) - {"environment", "not_implemented"})


@pytest.mark.parametrize("case", WORLD1_CASES)
def test_port_only_case_matches_world_size_1(group, case):
    alone = port_world1_results(case)
    for rank, res in enumerate(_case(group, case)):
        for key, want in alone.items():
            if not key.startswith("port:"):  # the port's own facts of one rank
                compare(res[key], want, rank, f"{case}/{key}", lshape_map=False)


def test_random_draws_are_split_invariant(group):
    res = _case(group, "random")[0]
    np.testing.assert_array_equal(res["randn:0"]["global"], res["randn:none"]["global"])
    np.testing.assert_array_equal(res["randn:1"]["global"], res["randn:none"]["global"])


def test_split_draws_compute_only_the_ranks_chunk(group):
    """The (9, 5) split-1 draw and the (1000, 7) split-0 draw fill exactly
    this rank's chunk (an empty one on the last rank for split 1), never
    the global array."""
    for rank, res in enumerate(_case(group, "random")):
        fills, (chunk95, chunk_big) = res["port:fills"]["value"], res["port:chunk_elems"]["value"]
        assert fills[1] == chunk95 and fills[-1] == chunk_big, (rank, fills, chunk95, chunk_big)
        assert chunk_big == res["big:0"]["local"].size and chunk95 == res["randn:1"]["local"].size
    assert [r["port:chunk_elems"]["value"][0] for r in _case(group, "random")] == [9 * 2, 9 * 2, 9, 0]


def test_not_implemented_names_say_which_roadmap_item(group):
    """The calls that raise above world size 1, each naming its ROADMAP
    item: none is left, so every public name works at world size 4 (the
    cases above)."""
    assert W.NOT_IMPLEMENTED == {}
    for rank, res in enumerate(_case(group, "not_implemented")):
        assert res == {}, (rank, res)


def test_ranks_run_the_group_they_were_given(group):
    for rank, res in enumerate(_case(group, "environment")):
        assert res["size"]["value"] == WORLD and res["rank"]["value"] == rank
        assert res["backend"]["value"] == "gloo" and res["device"]["value"] == "cpu"
        assert res["decision"]["value"] is True  # the OR of "am I the last rank"
        assert res["leaked"]["value"] == "", res["leaked"]


# the port's public names that take arrays, and the cases that drive each at world size 4
NON_ARRAY = {
    "BaseEstimator", "ClassificationMixin", "ClusteringMixin", "Communication", "DNDarray", "Device",
    "TorchCommunication", "canonical_heat_type", "heat_type_is_exact", "promote_types", "result_type",
    "get_comm", "get_device", "use_comm", "use_device", "sanitize_axis", "sanitize_comm", "sanitize_device",
    "sanitize_memory_layout", "sanitize_shape", "broadcast_shape", "is_classifier", "is_clusterer", "is_estimator",
    "init_distributed", "replicated_decision", "broadcast_shapes", "sanitize_distribution", "sanitize_in",
    "sanitize_in_tensor", "sanitize_infinity", "sanitize_lshape", "sanitize_out", "sanitize_sequence",
    "sanitize_slice", "sanitize_split", "validate_layout",
    "can_cast", "comm_context", "heat_type_is_complexfloating", "heat_type_is_inexact", "heat_type_of",
    "issubdtype", "is_regressor", "is_transformer", "get_printoptions", "set_printoptions", "local_printing",
    "global_printing", "print0",
}
EXPLICIT = {
    "array", "zeros", "ones", "full", "eye", "arange", "zeros_like", "ones_like", "full_like", "empty", "empty_like",
    "clip", "modf", "invert", "bitwise_not", "transpose", "cumsum", "cumprod", "cumproduct", "diff", "mean", "var",
    "std", "argmin", "argmax", "where", "nonzero", "matmul", "dot", "outer", "trace", "tril", "triu", "norm",
    "vector_norm", "matrix_norm", "copy", "rand", "randn", "randint", "random_integer", "random_sample", "ranf",
    "sample", "normal", "standard_normal", "uniform", "randperm", "permutation", "seed", "get_state", "set_state",
    "factor_block_edge", "cross", "det", "inv", "projection", "vdot", "vecdot",
    # manipulations, the factories' rest, order statistics, moments and histograms
    "asarray", "linspace", "logspace", "meshgrid", "balance", "broadcast_arrays", "broadcast_to", "column_stack",
    "concatenate", "diag", "diagonal", "dsplit", "expand_dims", "flatten", "flip", "fliplr", "flipud", "hsplit",
    "hstack", "moveaxis", "pad", "ravel", "redistribute", "repeat", "reshape", "resplit", "roll", "rot90",
    "row_stack", "shape", "sort", "split", "squeeze", "stack", "swapaxes", "tile", "topk", "unfold", "unique",
    "vsplit", "vstack", "scalar_to_1d", "percentile", "median", "nanmean", "average", "cov", "skew", "kurtosis",
    "histc", "histogram", "bincount", "bucketize", "digitize",
    # complex numbers and signal processing
    "angle", "conj", "conjugate", "imag", "real", "iscomplex", "isreal", "convolve",
    # file I/O and the stream's communication helpers
    "load", "load_csv", "load_hdf5", "load_netcdf", "save", "save_csv", "save_hdf5", "save_netcdf", "supports_hdf5",
    "supports_netcdf", "tree_merge", "tree_merge_rounds", "collective_lockstep",
    # the replicated metadata exchanges of the health monitor and the serve tick (case degrade)
    "replicated_ids", "replicated_frame",
    # the lazy layer (case lazy_lockstep)
    "lazy", "fuse", "reset_fuse_stats",
}


def test_every_public_name_is_driven_or_listed():
    public = {
        n for n in dir(htt)
        if not n.startswith("_") and callable(getattr(htt, n)) and not isinstance(getattr(htt, n), type)
    }
    driven = set(W.UNARY) | set(W.BINARY) | set(W.INT_BINARY) | set(W.REDUCTIONS) | EXPLICIT
    assert not sorted(public - driven - NON_ARRAY)
    assert not sorted(driven - public)
    src = WORKER.read_text()
    for name in EXPLICIT:
        assert f".{name}(" in src or f'"{name}"' in src, name  # called, or named in a loop of calls


@pytest.mark.gpu
def test_nccl_group_matches_world_size_1():
    """Two ranks over NCCL on two cards, against the port at world size 1
    on the CPU (kernels on the cards, their plain versions on the CPU)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least 2 CUDA cards")
    # not "factorizations" or "lu": a split operand's solve is split 0 above world size 1 and replicated at 1,
    # as in heat_tpu; chip_smoke.py's [dist] holds those routes on the cards
    names = ["layout", "binary", "reductions", "moments", "kmeans", "knn", "qr", "linalg", "random", "spatial",
             "solver", "svd", "spectral", "environment"]
    per_rank = run_group(2, "nccl", names, timeout=600)
    for case in names:
        alone = port_world1_results(case)
        rtol, atol = ((1e-4, 1e-4) if case in ("kmeans", "knn", "qr", "moments", "linalg", "spatial", "solver", "svd",
                                               "spectral") else (RTOL, ATOL))
        for rank, res in enumerate(per_rank):
            assert "__error__" not in res[case], res[case]["__error__"]
            for key, want in alone.items():
                if case == "environment" or key.startswith(("port:", "world:")):
                    continue
                compare(res[case][key], want, rank, f"{case}/{key}", rtol, atol, lshape_map=False, world=2)
    for rank, res in enumerate(per_rank):
        env = res["environment"]
        assert env["backend"]["value"] == "nccl" and env["device"]["value"] == f"cuda:{rank}"


def test_halos_are_one_batch_of_at_most_two_messages(group):
    """get_halo: every rank sends at most two halos of halo_size rows (in
    one batch, counted once) and gets at most two; the empty last rank
    sends and gets nothing; array_with_halos is the chunk and the halos it
    got."""
    per_rank = _case(group, "halos")
    row_bytes = {"a93_s0": 3 * 4, "a95_s1": 9 * 4, "i95_s0": 5 * 4, "c645_s2": 6 * 4 * 4}
    for rank, res in enumerate(per_rank):
        for name, rb in row_bytes.items():
            for hs in (1, 2, 3, 4):
                calls = res[f"port:rank:{name}:{hs}:halo_calls"]["value"]
                sent = res[f"port:rank:{name}:{hs}:halo_bytes"]["value"]
                assert calls <= 1 and sent <= 2 * hs * rb, (rank, name, hs, calls, sent)
                extra = res[f"port:rank:{name}:{hs}:with_halos"]["value"] - res[f"port:rank:{name}:{hs}:lshape"]["value"]
                assert extra == sent // rb, (rank, name, hs, extra, sent)  # as many rows got as sent
        assert res["port:rank:a93_s0:1:halo_calls"]["value"] == (0 if rank == WORLD - 1 else 1), rank


def test_complex_vdot_is_one_allreduce_of_the_scalar(group):
    for rank, res in enumerate(_case(group, "complex")):
        assert res["port:vdot_collectives"]["value"] == {"allreduce": 1}, rank


def test_ring_shift_moves_the_small_and_half_types(group):
    for rank, res in enumerate(_case(group, "small_dtypes")):
        for name in ("uint8", "int8", "int16", "float16", "bfloat16"):
            assert res[f"port:{name}:ring_shift_ok"]["value"] is True, (rank, name)


def test_stream_passes_run_their_collectives_per_chunk(group):
    """Over 4 split-0 chunks: StreamingKMeans one allreduce per chunk per
    epoch (4 epochs), StreamingMoments the two of moments_sharded per
    chunk, StreamingCov two, the histogram and HyperLogLog one; nothing
    else (no gather of a chunk)."""
    want = {"StreamingKMeans": 16, "StreamingMoments": 8, "StreamingCov": 8, "StreamingHistogram": 4,
            "HyperLogLog": 4}
    for rank, res in enumerate(_case(group, "stream")):
        assert res["chunks"]["value"] == 4
        for name, n in want.items():
            assert res[f"port:calls:{name}"]["value"] == {"allreduce": n}, (rank, name, res[f"port:calls:{name}"])


def test_tree_merge_takes_two_rounds_and_brackets_by_rank(group):
    """merge_processes of per-rank moments: log2(4) = 2 butterfly rounds,
    the merged state equal to one pass over all rows (and bit-identical on
    every rank, by the replicated-results test); a combine that is not
    commutative shows the balanced rank-ordered bracketing
    (s0 + s1) + (s2 + s3) with a + b = 2a + b: 4 s0 + 2 s1 + 2 s2 + s3."""
    for res in _case(group, "stream"):
        assert res["port:tree_merge_calls"]["value"] == 2
        assert res["port:merged_close"]["value"] is True
        assert res["port:kll_within_eps"]["value"] is True
        first, second = res["port:tree_merge_rank_order"]["items"]
        assert first["value"] == 4 * 1 + 2 * 2 + 2 * 3 + 4
        assert [i["value"] for i in second["items"]] == [0, 6, 12]


def test_csv_split_load_parses_byte_ranges_natively(group):
    for res in _case(group, "io"):
        routes = res["port:csv_routes"]["value"]
        # every whole-file load through the native parser; the one row window through heat_tpu's Python route
        assert routes == {"csv.native": 7, "csv.python": 1}, routes


def test_each_redistribute_is_one_move_receiving_only_the_rows_a_rank_lacks(group):
    """A redistribute to a new partition of the split axis is one
    ragged_move (no rebalance), and the bytes each rank receives are the
    rows of its new range it did not hold."""
    for rank, res in enumerate(_case(group, "redistribute")):
        for split in (0, 1):
            for name in ("tail", "head", "empty", "skew"):
                assert res[f"s{split}:{name}:counters"]["value"] == {
                    "rebalances": 0, "ragged_moves": 1, "bucket_moves": 0}, (rank, split, name)
                got, lacked = (i["value"] for i in res[f"port:rank:s{split}:{name}:received"]["items"])
                assert got == lacked, (rank, split, name, got, lacked)
        assert res["balance_:counters"]["value"] == {"rebalances": 1, "ragged_moves": 1, "bucket_moves": 0}


def test_ragged_arrays_compute_in_place_and_align_with_one_move(group):
    """The ragged discipline's counters on every rank: elementwise ops,
    reductions, cumulative ops, nonzero, copy and astype move nothing and
    rebalance nothing; unequal layouts align with one move into the first
    ragged operand's layout; getitem, setitem and out= rebalance once."""
    zero = {"rebalances": 0, "ragged_moves": 0, "bucket_moves": 0}
    one_move = {"rebalances": 0, "ragged_moves": 1, "bucket_moves": 0}
    one_rebalance = {"rebalances": 1, "ragged_moves": 1, "bucket_moves": 0}
    for rank, res in enumerate(_case(group, "ragged_ops")):
        assert res["in_place:counters"]["value"] == zero and res["empty:counters"]["value"] == zero, rank
        assert res["mismatch:counters"]["value"] == one_move and res["round_trip:counters"]["value"] == one_move
        assert res["canonical_first:counters"]["value"] == one_move
        assert res["mismatch"]["lcounts"] == res["add"]["lcounts"] == res["canonical_first"]["lcounts"]
        for name in ("getitem", "setitem", "out"):
            assert res[f"{name}:counters"]["value"] == one_rebalance, (rank, name)
        kept, equal, counters = (i["value"] for i in res["port:iadd"]["items"])
        assert kept and equal and counters == zero, (rank, res["port:iadd"])  # x += 1 keeps the ragged layout
    for rank, res in enumerate(_case(group, "ragged_kmeans")):
        assert res["z:counters"]["value"] == zero and res["z:lcounts"]["kind"] == "seq", rank
        assert res["fit:counters"]["value"]["rebalances"] == 1 and res["z_after_fit:balanced"]["value"] is True


def test_tree_merge_is_counted_in_move_stats(group):
    """merge_processes at four ranks: one tree_merge of log2(4) = 2 rounds in
    MOVE_STATS, as heat_tpu counts it."""
    for rank, res in enumerate(_case(group, "stream")):
        assert res["port:tree_merge_counted"]["value"] == {"tree_merges": 1, "tree_merge_rounds": 2}, rank


def test_meshes_are_device_meshes_of_the_ranks(group):
    """make_mesh/make_hierarchical_mesh in a running group: DeviceMeshes of
    the ranks with heat_tpu's shapes and axis names."""
    for rank, res in enumerate(_case(group, "parallel")):
        assert res["port:mesh:flat"]["value"] == repr(("DeviceMesh", (WORLD,), ("split",), list(range(WORLD)))), rank
        assert res["port:mesh:hierarchical"]["value"] == repr(
            ("DeviceMesh", (2, WORLD // 2), ("nodes", "split"), [[0, 1], [2, 3]])), rank


# ----------------------------------------------- the ML long tail and training
def test_gaussian_nb_merges_class_statistics_in_one_allreduce(group):
    """fit: the distinct labels (one allgather of the counts and one of the
    labels), one allreduce of k (2f + 1) values, and the two of the
    variance smoothing's moments."""
    for rank, res in enumerate(_case(group, "gaussian_nb")):
        assert res["port:fit_collectives"]["value"] == {"allgather": 2, "allreduce": 3}, rank


def test_lasso_costs_one_scalar_allreduce_per_coordinate(group):
    """A sweep: one allreduce of rho per coordinate (7 with the intercept);
    the fit: one more of the column norms."""
    for rank, res in enumerate(_case(group, "lasso")):
        n_iter = res["n_iter"]["value"]
        assert res["port:fit_collectives"]["value"] == {"allreduce": 1 + 7 * n_iter}, (rank, n_iter)


def test_data_parallel_uneven_shards_one_bucket_per_step(group):
    """30 rows: 8, 8, 8, 6; every step one allreduce (the gradients and the
    loss in one bucket); parameters bit-identical on every rank (the
    replicated-results test); BatchNorm over the ranks equals one process on
    the global batches."""
    per_rank = _case(group, "data_parallel")
    assert [r["port:rank:lshape"]["value"] for r in per_rank] == [8, 8, 8, 6]
    for rank, res in enumerate(per_rank):
        assert res["port:collectives"]["value"] == {"allreduce": len(W.DP_X)}, rank
        assert res["port:bn_close"]["value"] is True, rank


def test_daso_replicas_diverge_between_syncs_and_meet_at_them(group):
    """Warmup syncs every batch at once (gap 0 after each step of epoch 1);
    otherwise the replicas train apart between the syncs."""
    for rank, res in enumerate(_case(group, "daso")):
        gaps = [g["value"] for g in res["port:gaps"]["items"]]
        assert gaps[W.DASO_BATCHES : 2 * W.DASO_BATCHES] == [0.0] * W.DASO_BATCHES, (rank, gaps)
        assert min(gaps[: W.DASO_BATCHES]) > 1e-3 and max(gaps[2 * W.DASO_BATCHES :]) > 1e-3, (rank, gaps)


def test_attention_backward_collectives(group):
    """Ring: 2 (P - 1) ring_shifts (K and V as one message, and each block's
    dK/dV straight home); Ulysses: the 2 transposed alltoalls."""
    for rank, res in enumerate(_case(group, "attention_grad")):
        assert res["port:ring_backward_collectives"]["value"] == {"ring_shift": 2 * (WORLD - 1)}, rank
        assert res["port:ulysses_backward_collectives"]["value"] == {"alltoall": 2}, rank


def test_dryrun_body_checks_pass_on_every_rank(group):
    for rank, res in enumerate(_case(group, "dryrun")):
        assert res["port:qr_residual"]["value"] < 1e-3, rank
        gaps = [g["value"] for g in res["port:daso_gaps"]["items"]]
        assert gaps[0] < 1e-6 and gaps[2] < 1e-6 and gaps[1] > 1e-5 and gaps[3] > 1e-5, (rank, gaps)


def test_range_groupby_balances_the_ranks_c6(group):
    """Splitters from evenly spaced samples of each rank's sorted keys: on
    uniform keys each rank holds at most 2 G / P + 32 groups (heat_tpu's
    samples are each rank's 32 smallest keys, so its last rank merges almost
    all groups: ROADMAP.md, Queue C, C6)."""
    for rank, res in enumerate(_case(group, "frame")):
        lcounts = [c["value"] for c in res["port:range_lcounts"]["items"]]
        assert sum(lcounts) == W.FR_G and max(lcounts) <= res["port:range_bound"]["value"], (rank, lcounts)


def test_groupby_is_one_bucket_move_per_operand(group):
    """The hash groupby of six aggregations over a float32 and an int32
    column carries 10 raw statistics: 11 bucket moves, and two allgathers
    (the bucket matrix and the group counts)."""
    for rank, res in enumerate(_case(group, "frame")):
        assert res["port:groupby_collectives"]["value"] == {"allgather": 2, "flatmove.bucket": 11}, rank


def test_streaming_groupby_merges_in_log2_p_rounds_and_overflows_everywhere(group):
    for rank, res in enumerate(_case(group, "frame")):
        assert res["port:streaming_merge"]["value"] == {"tree_merges": 1, "tree_merge_rounds": 2}, rank
        assert res["port:overflow"]["type"] == "RuntimeError", rank
        assert f"capacity={W.FR_G - 1}" in res["port:overflow"]["message"], rank
        assert all(v["value"] for v in res["port:quantile_within_bound"]["items"]), rank
        np.testing.assert_array_equal(res["port:quantile_keys"]["value"], np.arange(4))


def test_checkpoints_cross_world_sizes_and_packages(group, tmp_path):
    """The 4-rank save's shard files are heat_tpu's bytes at 4 devices, and
    its manifest heat_tpu's but for the mesh; heat_tpu loads it at 4
    devices and at 1, the port loaded it alone and a one-process save on
    four ranks."""
    import jax

    import heat_tpu as htj
    from heat_tpu.core.communication import SELF, MeshCommunication, comm_context

    per_rank = _case(group, "resilience")
    res = per_rank[0]
    files, manifest = res["port:ckpt_files"]["value"], json.loads(res["port:ckpt_manifest"]["value"])
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    for name, data in files.items():
        (port_dir / name).write_bytes(data)
    (port_dir / "manifest.json").write_bytes(res["port:ckpt_manifest"]["value"])
    with comm_context(MeshCommunication(devices=jax.devices()[:WORLD])):
        htj.resilience.save_checkpoint(htj.array(W.CK_A, split=0), str(ref_dir), checksum="sha256")
        y = htj.resilience.load_checkpoint(str(port_dir))
        assert y.split == 0 and np.array_equal(np.asarray(y.numpy()), W.CK_A)
    with comm_context(SELF):
        np.testing.assert_array_equal(np.asarray(htj.resilience.load_checkpoint(str(port_dir)).numpy()), W.CK_A)
    assert files == {p.name: p.read_bytes() for p in ref_dir.iterdir() if p.name.startswith("shard_")}
    ref = json.loads((ref_dir / "manifest.json").read_text())
    assert manifest.pop("mesh") == {"axis_sizes": {"split": WORLD}, "split_size": WORLD, "processes": WORLD}
    ref.pop("mesh")
    assert manifest == ref
    for rank, r in enumerate(per_rank):
        assert r["port:loaded_alone"]["value"] is True, rank
        assert r["port:one_to_all"]["items"][0]["value"].tolist() == [[10, 6], [10, 6], [10, 6], [7, 6]], rank
        assert r["port:one_to_all"]["items"][1]["value"] is True, rank


def test_divergence_on_rank_2_alone_raises_naming_rank_2_everywhere(group):
    per_rank = _case(group, "resilience")
    messages = set()
    for rank, res in enumerate(per_rank):
        kind, message = (v["value"] for v in res["port:divergence"]["items"])
        assert kind == "DivergenceError" and "device(s) [2]" in message, (rank, message)
        messages.add(message)
        want = [("guard.shard", "divergence")] if rank == 2 else []
        assert [tuple(v["value"] for v in i["items"]) for i in res["port:rank:injected"]["items"]] == want, rank
    assert len(messages) == 1


# ----------------------------------------------- shrinking and growing groups
def _plain(v):
    """A packed value as plain python/numpy values."""
    if v["kind"] == "seq":
        return [_plain(i) for i in v["items"]]
    if v["kind"] == "array":
        return v["global"]
    return v["value"]


def test_degrade_moves_arrays_as_heat_tpu_on_the_surviving_devices(group):
    """Shrink 4 -> 3 (rank 2 out), grow 3 -> 4, shrink 4 -> 2, grow 2 -> 3 (a
    plain new group) and 3 -> 4, moving a split-0, a split-1, a replicated
    and a ragged array each time. Every rank holds the layout heat_tpu gives
    on the surviving devices (dtype, gshape, split, lshape_map); a survivor
    holds heat_tpu's values (exact: the move copies bytes) and, as its rows,
    heat_tpu's chunk of the survivor's position in the group; a rank outside
    the group holds no rows of a split array and the replicated array's
    values. A second shrink to the first one's ranks reuses its group and
    builds none on any rank."""
    per_rank = _case(group, "degrade")
    ref = heat_tpu_results("degrade")
    for res in per_rank:  # the unions over the base group, the same on every rank
        assert _plain(res["port:replicated_ids"]) == [0, 1, 2, 3, 10, 11, 12, 13]
        np.testing.assert_array_equal(res["port:replicated_frame"]["value"], [[r, -r] for r in range(4)])
        assert _plain(res["port:group_reused"]) is True and _plain(res["port:groups_added"]) == 0
    for key in ("sizes:shrink", "sizes:grow", "sizes:leg2"):
        assert _plain(ref[key]) == _plain(per_rank[0][key]), key
    members = {"shrink": [0, 1, 3], "grow": [0, 1, 2, 3], "leg2": [0, 1, 3], "leg2_back": [0, 1, 2, 3]}
    for rank, res in enumerate(per_rank):
        for tag, survivors in members.items():
            for i in range(4):
                dtype, gshape, split, lmap = _plain(res[f"{tag}:{i}"])
                want = _plain(ref[f"{tag}:{i}"])
                assert [dtype, list(gshape), split] == [want[0], list(want[1]), want[2]], (rank, tag, i)
                np.testing.assert_array_equal(lmap, want[3], err_msg=f"{tag}:{i} lshape_map")
                glob = ref[f"ref:{tag}:{i}"]["value"]
                member, local, got = _plain(res[f"port:rank:{tag}:{i}"])
                assert member == (rank in survivors), (rank, tag)
                if member:
                    np.testing.assert_array_equal(got, glob, err_msg=f"rank {rank} {tag}:{i}")
                    np.testing.assert_array_equal(local, _chunk(glob, lmap, split, survivors.index(rank)))
                else:
                    assert got is None
                    if split is None:
                        np.testing.assert_array_equal(local, glob)
                    else:
                        assert local.shape[split] == 0, (rank, tag, i, local.shape)


def test_supervised_kmeans_loses_a_rank_and_finishes_as_heat_tpu(group):
    """A supervised KMeans fit with device_loss at step 2: every rank marks
    the same rank (1, the schedule's draw, as heat_tpu's), the survivors
    shrink to three, restore the last checkpoint and finish with heat_tpu's
    centres (rtol 1e-5 / atol 1e-6: the same iterations, sums in another
    order), labels (exact), iteration count, group size and RECOVERY_STATS
    deltas; the lost rank detaches."""
    per_rank = _case(group, "supervisor")
    ref = heat_tpu_results("supervisor")
    centers, n_iter, inertia, size, labels = _plain(ref["ref:fit"])
    lost = _plain(ref["lost"])
    assert lost == [1] and _plain(ref["injected"]) == [["supervisor.step", "device_loss"]]
    for rank, res in enumerate(per_rank):
        assert _plain(res["lost"]) == lost and _plain(res["injected"]) == _plain(ref["injected"]), rank
        compare(res["clean"], ref["clean"], rank, "supervisor/clean")
        if rank in lost:
            assert _plain(res["port:rank:detached"]) is True and _plain(res["port:rank:fit"]) is None
            continue
        assert _plain(res["port:rank:detached"]) is False, rank
        assert _plain(res["port:rank:counters"]) == _plain(ref["ref:counters"]), rank
        p_centers, p_iter, p_inertia, p_size, p_labels = _plain(res["port:rank:fit"])
        np.testing.assert_allclose(p_centers, centers, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(p_centers, ref["clean"]["global"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(p_inertia, inertia, rtol=1e-5)
        np.testing.assert_array_equal(p_labels, labels)
        assert (p_iter, p_size) == (n_iter, size) == (12, 3), rank


def test_served_requests_survive_a_lost_rank_once_each(group):
    """The tick-armed service with one device_loss at a dispatch: every
    request is answered exactly once on every rank; the survivors answer
    every request with the rows of heat_tpu's models (labels exact), the
    lost rank with rows or a DegradeError naming it, at least the in-flight
    batch's. (heat_tpu's own service, run alongside, keeps its kNN training
    set on the devices of the old mesh and answers the kNN requests after
    the shrink with PoisonRequestError: the port moves every model's live
    arrays.)"""
    per_rank = _case(group, "serve")
    ref = heat_tpu_results("serve")
    want = _plain(ref["want"])
    lost_rank = 1  # the schedule's draw, as in the supervisor case
    assert _plain(ref["ref:size_after"]) == 3
    for rank, res in enumerate(per_rank):
        for got, w in zip(_plain(res["want"]), want):
            np.testing.assert_array_equal(got, w)
        assert _plain(res["answered_once"]) == [1] * len(want), rank
        answers = _plain(res["port:rank:answers"])
        assert _plain(res["port:rank:member"]) == (rank != lost_rank)
        assert _plain(res["port:rank:size_after"]) == 3
        stats = _plain(res["port:rank:stats"])
        assert stats["requests"] == len(want) and stats["shrinks"] == 1, (rank, stats)
        errors = 0
        for (kind, value), w in zip(answers, want):
            if kind == "rows":
                np.testing.assert_array_equal(value, w, err_msg=f"rank {rank}")
            else:
                assert rank == lost_rank and kind == "DegradeError" and f"rank {rank}" in value, (rank, kind, value)
                errors += 1
        assert (errors > 0) == (rank == lost_rank), (rank, errors)
