"""Printing (counterpart of ``heat_tpu/core/printing.py``).

``str``/``repr`` of a DNDarray format the global array with numpy under
torch-like options (precision 4, threshold 1000, edge items 3, line width
120). An array larger than the threshold is summarised from its edges: each
long axis keeps ``edgeitems + 1`` rows at either end, and along the split
axis only those rows travel (one ``alltoall`` that brings every rank the
edge rows, never the whole array). ``local_printing()`` shows each rank's
own chunk instead; ``print0`` prints on rank 0 only.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

__all__ = [
    "get_printoptions",
    "global_printing",
    "local_printing",
    "print0",
    "set_printoptions",
]

__PRINT_OPTIONS = dict(precision=4, threshold=1000, edgeitems=3, linewidth=120, sci_mode=None)

# True: print each rank's own chunk
LOCAL_PRINT = False


def get_printoptions() -> dict:
    """The current print options."""
    return dict(__PRINT_OPTIONS)


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None, sci_mode=None):
    """Set the print options; ``profile`` is ``"default"``, ``"short"`` or
    ``"full"`` (no summary). As in torch, ``sci_mode`` returns to automatic
    on every call that does not pass it."""
    if profile == "default":
        __PRINT_OPTIONS.update(precision=4, threshold=1000, edgeitems=3, linewidth=120)
    elif profile == "short":
        __PRINT_OPTIONS.update(precision=2, threshold=1000, edgeitems=2, linewidth=120)
    elif profile == "full":
        __PRINT_OPTIONS.update(precision=4, threshold=float("inf"), edgeitems=3, linewidth=120)
    for key, value in dict(precision=precision, threshold=threshold, edgeitems=edgeitems,
                           linewidth=linewidth).items():
        if value is not None:
            __PRINT_OPTIONS[key] = value
    __PRINT_OPTIONS["sci_mode"] = sci_mode


def local_printing() -> None:
    """Print each rank's own chunk from now on."""
    global LOCAL_PRINT
    LOCAL_PRINT = True


def global_printing() -> None:
    """Print the global array from now on (the default)."""
    global LOCAL_PRINT
    LOCAL_PRINT = False


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only."""
    from .communication import get_comm

    if get_comm().rank == 0:
        print(*args, **kwargs)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _edge_data(x, edgeitems: int) -> np.ndarray:
    """The global array cut to the ``edgeitems + 1`` rows at either end of
    each axis longer than ``2 * edgeitems + 2`` (numpy prints shorter axes
    whole). Other axes are cut locally; the split axis by fetching just the
    edge rows from the ranks that hold them."""
    from ._movement import take_rows

    def edges(extent):
        return np.r_[0:edgeitems + 1, extent - edgeitems - 1:extent] if extent > 2 * edgeitems + 2 else \
            np.arange(extent)

    split = x.split if x.split is not None and x.comm.is_distributed() else None
    t = x.larray
    gshape = list(x.gshape)
    for axis, extent in enumerate(x.gshape):
        if axis != split and extent > 2 * edgeitems + 2:
            t = t.index_select(axis, torch.as_tensor(edges(extent), device=t.device))
            gshape[axis] = 2 * edgeitems + 2
    if split is None:
        return _host(t)
    rows = edges(x.gshape[split])
    return _host(take_rows(t, tuple(gshape), split, lambda r: rows, x.comm))


def _array2string(data: np.ndarray, opts: dict, force_summary: bool = False) -> str:
    """numpy's formatting under ``opts``; ``sci_mode`` True forces
    scientific notation, False suppresses it, None lets numpy decide."""
    threshold = opts["threshold"] if np.isfinite(opts["threshold"]) else data.size + 1
    if force_summary:
        # the caller already cut each long axis to its edges: make numpy print the "..."
        threshold = builtins.max(data.size - 1, 0)
    kwargs = dict(precision=opts["precision"], threshold=threshold, edgeitems=opts["edgeitems"],
                  linewidth=opts["linewidth"])
    if opts.get("sci_mode") is True:
        precision = opts["precision"]

        def sci(v):
            return np.format_float_scientific(v, precision=precision)

        kwargs["formatter"] = {
            "float_kind": sci,
            "complex_kind": lambda z: f"{sci(z.real)}{'+' if z.imag >= 0 else '-'}{sci(builtins.abs(z.imag))}j",
        }
    elif opts.get("sci_mode") is False:
        kwargs["suppress"] = True
    with np.printoptions(**kwargs):
        return np.array2string(data, separator=", ", prefix="DNDarray(")


def __str__(x) -> str:
    """The text of a DNDarray: its values, dtype, device and split."""
    opts = __PRINT_OPTIONS
    if LOCAL_PRINT:
        body = _array2string(_host(x.larray), opts)
    else:
        summarize = np.isfinite(opts["threshold"]) and x.size > opts["threshold"]
        if summarize:
            body = _array2string(_edge_data(x, opts["edgeitems"]), opts, force_summary=True)
        else:
            body = _array2string(x.numpy(), opts)
    return f"DNDarray({body}, dtype=ht.{x.dtype.__name__}, device={x.device}, split={x.split})"
