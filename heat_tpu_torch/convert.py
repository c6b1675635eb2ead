"""Carry state from ``heat_tpu`` into this package.

``heat_tpu``'s estimators export their state as plain host values
(``state_dict()``: numpy arrays and python scalars). These functions build
the port's objects from such values; they import nothing of ``heat_tpu``.

Flax parameter trees (as numpy) become a torch module's ``state_dict``:
the k-th flax layer of a kind (``Dense_k``, ``Conv_k``, ``BatchNorm_k``,
``LayerNorm_k``, ``Embed_k``, by index within its parent, parents in
order) fills the k-th torch layer of that kind in ``module.modules()``
order: a ``Dense`` kernel (in, out) is ``Linear.weight`` (out, in), a
``Conv`` kernel (spatial..., in, out) is (out, in, spatial...), BatchNorm's
scale/bias/mean/var are ``weight``/``bias``/``running_mean``/
``running_var``, LayerNorm's scale/bias ``weight``/``bias``, and an
``Embed``'s embedding ``Embedding.weight``. A ``Dense`` after a flatten of
NHWC activations would need its input rows permuted to torch's NCHW
flatten; the converter does not do that.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .classification.kneighborsclassifier import KNeighborsClassifier
from .cluster.kmeans import KMeans
from .cluster.kmedians import KMedians
from .cluster.kmedoids import KMedoids
from .cluster.spectral import Spectral
from .core import factories, types
from .core.communication import sanitize_comm
from .core.dndarray import DNDarray
from .frame import Frame
from .naive_bayes.gaussianNB import GaussianNB
from .regression.lasso import Lasso
from .stream.groupby import StreamingGroupBy

__all__ = [
    "array_from_numpy", "dp_state_from_heat_tpu", "flax_to_state_dict", "frame_from_heat_tpu", "from_heat_tpu_state",
    "gaussian_nb_from_heat_tpu", "knn_from_heat_tpu", "lasso_from_heat_tpu", "spectral_from_heat_tpu",
    "streaming_groupby_from_heat_tpu",
]


def array_from_numpy(a, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A DNDarray holding the numpy array ``a`` (its dtype kept), with split
    axis ``split``, on ``device`` (default: the default device)."""
    return factories.array(np.asarray(a), split=split, device=device, comm=comm)


_ESTIMATORS = {"kmeans": KMeans, "kmedians": KMedians, "kmedoids": KMedoids}


def from_heat_tpu_state(d: dict, device=None, comm=None, estimator: str = "kmeans"):
    """A fitted port :class:`KMeans` (or :class:`KMedians`,
    :class:`KMedoids`, by ``estimator``) from the dictionary that the
    ``heat_tpu`` estimator's ``state_dict()`` returns."""
    missing = {"n_clusters", "max_iter", "tol", "random_state"} - set(d)
    if missing:
        raise KeyError(f"not a k-clustering state dictionary: missing {sorted(missing)}")
    if estimator not in _ESTIMATORS:
        raise ValueError(f"estimator must be one of {sorted(_ESTIMATORS)}, got {estimator!r}")
    return _ESTIMATORS[estimator]().load_state_dict(d, comm=comm, device=device)


def knn_from_heat_tpu(x, y, n_neighbors: int = 5, split: Optional[int] = None, device=None, comm=None) -> KNeighborsClassifier:
    """A fitted port :class:`KNeighborsClassifier` from the training set
    and labels of a ``heat_tpu`` classifier, as numpy arrays (``clf.x.numpy()``,
    ``clf.y.numpy()``): a kNN classifier's only state is its training set.
    ``split`` is the training set's split axis."""
    x, y = np.asarray(x), np.asarray(y)
    if x.ndim != 2 or y.ndim != 1 or x.shape[0] != y.shape[0]:
        raise ValueError(f"need an (n, f) training set and n labels, got {x.shape} and {y.shape}")
    clf = KNeighborsClassifier(n_neighbors=n_neighbors)
    return clf.fit(
        array_from_numpy(x, split=split, device=device, comm=comm),
        array_from_numpy(y, split=split, device=device, comm=comm),
    )


def spectral_from_heat_tpu(params: dict, kmeans_state: dict, device=None, comm=None) -> Spectral:
    """A fitted port :class:`Spectral` from a fitted ``heat_tpu`` one: its
    ``get_params()`` and its KMeans' ``state_dict()`` (``sp._cluster``).
    ``predict`` then embeds new data as ``heat_tpu`` does and labels it by
    the carried centroids; ``labels_`` are the carried labels."""
    names = set(Spectral._parameter_names())
    unknown = set(params) - names
    if unknown:
        raise KeyError(f"not Spectral parameters: {sorted(unknown)}")
    sp = Spectral(**params)
    sp._cluster = from_heat_tpu_state(kmeans_state, device=device, comm=comm)
    sp._cluster.init = "probability_based"
    if sp.n_clusters is None:
        sp.n_clusters = sp._cluster.n_clusters
    sp._labels = sp._cluster.labels_
    return sp


# ------------------------------------------------------------------ Lasso, GaussianNB
def lasso_from_heat_tpu(d: dict, device=None, comm=None) -> Lasso:
    """A port :class:`Lasso` from ``heat_tpu``'s ``Lasso.state_dict()``."""
    return Lasso().load_state_dict(d, comm=comm, device=device)


_GNB_ATTRS = ("classes_", "theta_", "sigma_", "class_prior_", "class_count_")


def gaussian_nb_from_heat_tpu(attrs: dict, device=None, comm=None) -> GaussianNB:
    """A fitted port :class:`GaussianNB` from a fitted ``heat_tpu`` one's
    attributes as numpy (``classes_``, ``theta_``, ``sigma_``,
    ``class_prior_``, ``class_count_``; ``epsilon_`` a float; ``priors`` and
    ``var_smoothing`` optional)."""
    missing = set(_GNB_ATTRS + ("epsilon_",)) - set(attrs)
    if missing:
        raise KeyError(f"not fitted GaussianNB attributes: missing {sorted(missing)}")
    nb = GaussianNB(priors=attrs.get("priors"), var_smoothing=attrs.get("var_smoothing", 1e-9))
    for name in _GNB_ATTRS:
        setattr(nb, name, array_from_numpy(attrs[name], device=device, comm=comm))
    nb.epsilon_ = float(attrs["epsilon_"])
    return nb


# ------------------------------------------------------------------ flax trees
_LAYER = re.compile(r"^(.*)_(\d+)$")
_KINDS = {
    "Dense": (torch.nn.Linear,),
    "Conv": (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d),
    "BatchNorm": (torch.nn.modules.batchnorm._BatchNorm,),
    "LayerNorm": (torch.nn.LayerNorm,),
    "Embed": (torch.nn.Embedding,),
}


def _ordered(tree: dict):
    """``tree``'s children, numbered ones (``Name_k``) by their number."""
    def key(name):
        m = _LAYER.match(name)
        return (m.group(1), int(m.group(2))) if m else (name, -1)

    return sorted(tree.items(), key=lambda kv: key(kv[0]))


def _flax_layers(tree: dict, path=()):
    """(kind, path) of every flax layer in ``tree``, depth first."""
    for name, sub in _ordered(tree):
        m = _LAYER.match(name)
        if m and m.group(1) in _KINDS:
            yield m.group(1), path + (name,)
        elif isinstance(sub, dict):
            yield from _flax_layers(sub, path + (name,))


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """flax (spatial..., in, out) -> torch (out, in, spatial...)."""
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def _sources(variables: dict, module: torch.nn.Module) -> Dict[str, Tuple[str, tuple, object]]:
    """For each torch state name: (flax collection, path in it, transform)."""
    params = variables.get("params", variables)
    layers = {kind: [] for kind in _KINDS}
    for kind, path in _flax_layers(params):
        layers[kind].append(path)
    if not any(layers.values()):  # the tree of one bare layer: its kind is the module's
        kinds = [k for _, m in module.named_modules() for k, types_ in _KINDS.items() if isinstance(m, types_)]
        if len(kinds) == 1:
            layers[kinds[0]].append(())
    out = {}
    used = {kind: 0 for kind in _KINDS}
    for mname, mod in module.named_modules():
        kind = next((k for k, types_ in _KINDS.items() if isinstance(mod, types_)), None)
        if kind is None:
            continue
        if used[kind] >= len(layers[kind]):
            raise ValueError(f"the module has more {kind} layers than the flax tree ({len(layers[kind])})")
        path = layers[kind][used[kind]]
        used[kind] += 1
        pre = f"{mname}." if mname else ""
        same = lambda a: a  # noqa: E731
        if kind == "Dense":
            out[pre + "weight"] = ("params", path + ("kernel",), np.transpose)
            if mod.bias is not None:
                out[pre + "bias"] = ("params", path + ("bias",), same)
        elif kind == "Conv":
            out[pre + "weight"] = ("params", path + ("kernel",), _conv_kernel)
            if mod.bias is not None:
                out[pre + "bias"] = ("params", path + ("bias",), same)
        elif kind == "Embed":
            out[pre + "weight"] = ("params", path + ("embedding",), same)
        else:  # BatchNorm, LayerNorm
            if getattr(mod, "weight", None) is not None:
                out[pre + "weight"] = ("params", path + ("scale",), same)
            if getattr(mod, "bias", None) is not None:
                out[pre + "bias"] = ("params", path + ("bias",), same)
            if kind == "BatchNorm" and mod.track_running_stats:
                out[pre + "running_mean"] = ("batch_stats", path + ("mean",), same)
                out[pre + "running_var"] = ("batch_stats", path + ("var",), same)
    extra = {k: len(v) - used[k] for k, v in layers.items() if len(v) > used[k]}
    if extra:
        raise ValueError(f"the flax tree has layers the module lacks: {extra}")
    return out


def _lookup(tree: dict, path: tuple):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def flax_to_state_dict(variables: dict, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``module`` (its entries that flax holds) from a
    flax variable tree as numpy: ``{"params": ..., "batch_stats": ...}``,
    or the ``params`` tree alone."""
    live = module.state_dict()
    trees = variables if "params" in variables else {"params": variables}
    out = {}
    for name, (coll, path, fn) in _sources(variables, module).items():
        t = live[name]
        out[name] = torch.as_tensor(np.ascontiguousarray(fn(_lookup(trees[coll], path)))).to(dtype=t.dtype,
                                                                                           device=t.device)
    return out


_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_][A-Za-z_0-9]*)")


def _parse_keystr(key: str):
    """``"params['params']['Dense_0']['kernel']"`` -> ("params", ("params", "Dense_0", "kernel"))."""
    head = re.match(r"^[A-Za-z_][A-Za-z_0-9]*", key).group(0)
    parts = tuple(a or (int(b) if b else c) for a, b, c in _KEY.findall(key[len(head):]))
    return head, parts


def _nest(items) -> dict:
    out: dict = {}
    for path, value in items:
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = value
    return out


# optax state fields and the torch optimizer state they are
_OPT_FIELDS = {"trace": "momentum_buffer", "mu": "exp_avg", "nu": "exp_avg_sq"}


def dp_state_from_heat_tpu(d: dict, model) -> dict:
    """``heat_tpu``'s ``DataParallel.state_dict()`` (keys are pytree key
    paths) as the port's (``params.<name>``, ``opt.<i>.<field>``, ``seed``)
    for ``model`` (a port DataParallel or its module). The optimizer state
    carried: optax ``sgd``'s momentum trace (torch SGD's
    ``momentum_buffer``) and ``adam``'s mu/nu/count (torch Adam's
    ``exp_avg``/``exp_avg_sq``/``step``); i numbers the module's parameters
    in ``parameters()`` order, as an optimizer built on them does."""
    module = getattr(model, "module", model)
    params, opt = [], {}
    for key, v in d.items():
        if key == "seed":
            continue
        head, path = _parse_keystr(key)
        if head == "params":
            params.append((path, np.asarray(v)))
        elif head == "opt" and len(path) >= 2:
            opt.setdefault(path[1], []).append((path[2:], np.asarray(v)))
    variables = _nest(params)
    out = {f"params.{k}": v.cpu().numpy() for k, v in flax_to_state_dict(variables, module).items()}
    sources = _sources(variables, module)
    index = {name: i for i, (name, _) in enumerate(module.named_parameters())}
    for field, items in opt.items():
        if field == "count":
            for i in index.values():
                out[f"opt.{i}.step"] = np.asarray(items[0][1], dtype=np.float32)
            continue
        if field not in _OPT_FIELDS:
            continue
        tree = _nest(items)
        trees = tree if "params" in tree else {"params": tree}
        for name, i in index.items():
            coll, path, fn = sources[name]
            out[f"opt.{i}.{_OPT_FIELDS[field]}"] = np.ascontiguousarray(fn(_lookup(trees[coll], path)))
    if "seed" in d:
        out["seed"] = d["seed"]
    return out


def frame_from_heat_tpu(columns: dict, lcounts=None, device=None, comm=None) -> Frame:
    """A port :class:`~heat_tpu_torch.frame.Frame` from a ``heat_tpu``
    Frame's columns as numpy (its ``to_dict()``) and its layout: ``lcounts``
    (the columns' ``lcounts``, one count per rank) puts rank r's rows where
    ``heat_tpu``'s shard r has them; None gives the ceil-div layout."""
    comm = sanitize_comm(comm)
    if lcounts is None:
        return Frame({name: factories.array(np.asarray(col), split=0, device=device, comm=comm)
                      for name, col in columns.items()})
    lcounts = tuple(int(c) for c in lcounts)
    if len(lcounts) != comm.size:
        raise ValueError(f"lcounts {lcounts} name {len(lcounts)} shards, the world has {comm.size} ranks")
    lo = sum(lcounts[: comm.rank])
    cols = {}
    for name, col in columns.items():
        col = np.asarray(col)
        mine = factories.array(col[lo : lo + lcounts[comm.rank]], device=device, comm=comm)
        cols[name] = DNDarray._from_ragged(mine._raw, (col.shape[0],), mine.dtype, 0, lcounts, device=mine.device,
                                           comm=comm)
    return Frame(cols)


def streaming_groupby_from_heat_tpu(d: dict, device=None, comm=None) -> StreamingGroupBy:
    """A port :class:`~heat_tpu_torch.stream.StreamingGroupBy` holding a
    ``heat_tpu`` one's state, so that a fold begun in one package goes on in
    the other. ``d`` holds ``aggs``, ``capacity``, ``n`` (rows folded),
    ``keys`` (its table's key slots), ``g`` (the groups in use), ``overflow``
    and ``stats`` (the statistic slots, in the object's ``_kinds`` order:
    count first, then each aggregation's in order, as both packages carry
    them); and ``value_dtype``, the values' numpy type name (else a min's,
    max's or sum's type stands for it, else float32). Above one rank the table goes to rank 0 (the ranks' tables
    are merged at ``result()``)."""
    comm = sanitize_comm(comm)
    out = StreamingGroupBy(d["aggs"], capacity=int(d["capacity"]))
    if len(d["stats"]) != len(out._kinds):
        raise ValueError(f"{len(d['stats'])} statistics for kinds {out._kinds}")
    g = int(d["g"]) if comm.rank == 0 else 0
    keys = factories.array(np.asarray(d["keys"])[:g], device=device, comm=comm)
    stats = [factories.array(np.asarray(s)[:g], device=device, comm=comm) for s in d["stats"]]
    slot = dict(zip(out._kinds, stats))
    if "value_dtype" in d:
        vdt = types.canonical_heat_type(str(d["value_dtype"])).torch_type()
    else:
        vdt = next((slot[k].larray.dtype for k in ("min", "max", "sum") if k in slot), torch.float32)
    out._start(keys.larray.dtype, vdt, keys.device, comm)
    out._keys = keys.larray
    out._stats = tuple(s.larray.to(t.dtype) for s, t in zip(stats, out._stats))
    out._ov = bool(d["overflow"]) if comm.rank == 0 else False
    out._n = int(d["n"])
    return out
