"""Entry points: one step of the flagship path, and a dry run across ranks
(counterpart of the repository's ``__graft_entry__.py``).

- :func:`entry` returns ``(fn, example_args)``: ``fn(x, centers)`` is one
  Lloyd iteration with k = 8 (assignment, statistics and the centroid
  update), through the ``lloyd_fused`` kernel on a card and its plain
  version on the CPU.
- :func:`dryrun_body` is what one rank of the dry run checks, in a group
  that is already running: KMeans with 2 iterations, the TSQR residual,
  ``ring_map`` and ``halo_exchange``, ring and Ulysses attention on lengths
  the ranks do not divide, and, at an even world size of at least 4, DASO's
  diverge-and-meet over a (2 x P/2) mesh.
- :func:`dryrun_multichip` starts ``n_devices`` processes (NCCL, one card
  each; gloo where the caller asks for the CPU) and runs the body in each.

Run as ``python -m heat_tpu_torch.entry [--cpu] [N]``.
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

K_ENTRY = 8


def entry(device=None) -> Tuple[object, tuple]:
    """``(fn, example_args)``: ``fn(x, centers)`` is one Lloyd iteration with
    k = 8 and returns the new centers; the example arguments are a (1024,
    32) float32 zero matrix and (8, 32) ones on ``device`` (default: the
    default device)."""
    from .cluster.kmeans import _lloyd_body
    from .core import devices
    from .core.kernels import LLOYD_KERNEL, dispatch_mode, record_dispatch

    def fn(xa: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        if centers.shape[0] != K_ENTRY:
            raise ValueError(f"entry's step takes {K_ENTRY} centers, got {centers.shape[0]}")
        mode = dispatch_mode(LLOYD_KERNEL, xa)
        record_dispatch(LLOYD_KERNEL, mode)
        new_centers, _, _ = _lloyd_body(xa, centers, None, mode)
        return new_centers

    dev = devices.sanitize_device(device).torch_device
    example_args = (torch.zeros((1024, 32), dtype=torch.float32, device=dev),
                    torch.ones((K_ENTRY, 32), dtype=torch.float32, device=dev))
    return fn, example_args


def dryrun_body(ht) -> dict:
    """The dry run's checks in this rank of a running group (``ht`` is the
    ``heat_tpu_torch`` module); raises on a failed check, returns what it
    computed."""
    comm = ht.get_comm()
    p = comm.size
    n, f, k = 16 * p, 8, 4
    rng = np.random.default_rng(0)
    data = rng.normal(size=(n, f)).astype(np.float32)
    x = ht.array(data, split=0)
    out = {}

    # KMeans fit: random init from the stream, 2 Lloyd iterations (one allreduce each)
    km = ht.cluster.KMeans(n_clusters=k, init="random", max_iter=2, random_state=0).fit(x)
    if km.cluster_centers_.shape != (k, f):
        raise AssertionError(f"KMeans centers {km.cluster_centers_.shape}")
    out["centers"] = km.cluster_centers_

    # TSQR and its residual
    q, r = ht.linalg.qr(x)
    err = float(ht.linalg.norm(ht.matmul(q, r) - x))
    if not err < 1e-3:
        raise AssertionError(f"TSQR residual too large: {err}")
    out["qr_residual"] = err

    # the ring pipeline and the halo exchange
    d = ht.parallel.ring_map(lambda a, b: (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T, x, x, comm)
    if d.shape != (n, n):
        raise AssertionError(f"ring_map {d.shape}")
    h = ht.parallel.halo_exchange(x, 2, comm)
    if h.shape != (p, n // p + 4, f):
        raise AssertionError(f"halo_exchange {h.shape}")
    out["ring_map"], out["halo"] = d, h

    # sequence parallelism on a length the ranks do not divide: ring, then Ulysses (heads not divisible either)
    seq_n = 8 * p + max(1, p // 2)
    seq = ht.array(rng.normal(size=(seq_n, f)).astype(np.float32), split=0)
    att = ht.parallel.ring_attention(seq, seq, seq, comm, causal=True)
    if att.shape != seq.shape:
        raise AssertionError(f"ring_attention {att.shape}")
    mh = ht.array(rng.normal(size=(seq_n, p + 1, f)).astype(np.float32), split=0)
    uatt = ht.parallel.ulysses_attention(mh, mh, mh, comm, causal=True)
    if uatt.shape != mh.shape:
        raise AssertionError(f"ulysses_attention {uatt.shape}")
    out["ring_attention"], out["ulysses_attention"] = att, uatt

    if p >= 4 and p % 2 == 0:
        out.update(_daso_check(ht, f, rng))
    return out


def _daso_check(ht, f: int, rng) -> dict:
    """DASO on a (2 x P/2) mesh with group-dependent targets: the replicas
    must diverge between global syncs and meet at them."""
    p = ht.get_comm().size
    dev = ht.get_device().torch_device
    mesh = ht.parallel.make_hierarchical_mesh(n_slow=2)
    model = torch.nn.Linear(f, 1, bias=False).to(dev)
    with torch.no_grad():
        model.weight.zero_()
    daso = ht.optim.DASO(torch.optim.SGD(model.parameters(), lr=0.1), total_epochs=4, warmup_epochs=0,
                         cooldown_epochs=0)
    model = daso.init(model, mesh)
    # schedule knobs after init (init resets the schedule): the cycling phase, a sync every 2 batches
    daso.epoch, daso.global_skip, daso.batches_to_wait = 1, 2, 0
    batch = torch.as_tensor(rng.normal(size=(4 * p, f)).astype(np.float32), device=dev)
    ytgt = torch.cat([torch.ones(2 * p), -torch.ones(2 * p)]).to(dev)

    def loss_fn(m, xb, yb):
        return torch.mean((m(xb)[:, 0] - yb) ** 2)

    diverged = synced = False
    gaps = []
    for b in range(4):
        model, _loss = daso.step(loss_fn, model, batch, ytgt)
        w = model.weight.detach().reshape(-1)
        gap = float(_replica_gap(w, daso))
        gaps.append(gap)
        if b % daso.global_skip == 0:
            synced = synced or gap < 1e-6
        else:
            diverged = diverged or gap > 1e-5
    if not (synced and diverged):
        raise AssertionError(f"DASO replicas must diverge between syncs and meet at syncs: gaps {gaps}")
    final = daso.consolidated_params(model)
    if tuple(final["weight"].shape) != (1, f):
        raise AssertionError(f"consolidated weight {tuple(final['weight'].shape)}")
    return {"daso_gaps": gaps, "daso_final": final["weight"].cpu().numpy()}


def _replica_gap(w: torch.Tensor, daso) -> torch.Tensor:
    """max |w(group 0) - w(group 1)|, the same on every rank: each group's
    replica summed over the slow axis with signs."""
    from .nn.data_parallel import group_allreduce

    sign = 1.0 if daso._group == 0 else -1.0
    return group_allreduce(w * sign, daso._slow).abs().max()


def _dryrun_rank(rank: int, world: int, store: str, cpu: bool) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import heat_tpu_torch as ht

    if cpu:
        torch.set_num_threads(1)
        ht.use_device("cpu")
    ht.init_distributed(backend="gloo" if cpu else "nccl", init_method=f"file://{store}", world_size=world, rank=rank,
                        local_rank=rank, timeout=300)
    try:
        dryrun_body(ht)
        ht.get_comm().barrier()
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run :func:`dryrun_body` in ``n_devices`` processes, one per card over
    NCCL, or over gloo on the CPU when ``device`` is ``"cpu"``."""
    import torch.multiprocessing as mp

    cpu = device is not None and str(device).startswith("cpu")
    if not cpu and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, found "
                           f"{torch.cuda.device_count()}; pass device='cpu' for gloo processes")
    with tempfile.TemporaryDirectory(prefix="heat_tpu_torch_dryrun_") as tmp:
        mp.start_processes(_dryrun_rank, args=(n_devices, os.path.join(tmp, "store"), cpu), nprocs=n_devices,
                           join=True, start_method="spawn")
    print(f"dryrun_multichip({n_devices}): OK")


def main(argv: Optional[list] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    rest = [a for a in argv if a != "--cpu"]
    fn, args = entry("cpu" if cpu else None)
    print("entry() runs:", tuple(fn(*args).shape))
    dryrun_multichip(int(rest[0]) if rest else (1 if cpu else torch.cuda.device_count()), "cpu" if cpu else None)


if __name__ == "__main__":
    main()
