#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path on one CUDA card and check every kernel.

Run from the repository root, with no arguments, on a machine with an
NVIDIA Hopper card and the CUDA toolkit:

    python3 chip_smoke.py                  # every phase; [dist] on every visible card
    python3 chip_smoke.py --phases dist    # the build and [dist] only
    python3 chip_smoke.py --phases stream  # the build and [stream] only
    python3 chip_smoke.py --phases layout  # the build and [layout] only
    python3 chip_smoke.py --phases train   # the build and [train] only
    python3 chip_smoke.py --phases frame   # the build and [frame] only (or --phases resilience)
    python3 chip_smoke.py --phases serve   # the build and [serve] only
    python3 chip_smoke.py --phases lazy    # the build and [lazy] only

Phases (any failure raises and exits non-zero; nothing is caught):

1. Environment: the card, its power limit, torch and CUDA versions.
2. Build: every ``heat_tpu_torch/core/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (in parallel), with ptxas' register / shared-memory report,
   and the native library of ``heat_tpu_torch/native/src`` with ``g++``.
3. Each kernel against its plain PyTorch version on the card, at several
   shapes, main-path shapes included, with the tolerances below;
   ``lloyd_fused`` on both of its routes (``resident`` and ``general``),
   f up to 4097 and k * f past 8192; ``threefry_bits`` bit-identical to
   its plain version (bits, uniform float32 and float64, the main path's
   2^24 x 32 normal draw, and the permutation ``KMeans(init="random")``
   takes at n = 2^24).
4. Three paths at full width, each with its kernel launch counts zeroed
   just before and read just after, and held against the same path
   through the plain versions:
   - KMeans: 8 Gaussian blobs, n = 2^24 rows x f = 32 float32 (2 GiB;
     ``bench.py``'s k, f and iteration count at 32x its rows) drawn with
     ``ht.random.randn``, ``mean``/``std`` along axis 0, standardize,
     ``KMeans(8, init=8 rows of z, max_iter=30, tol=None).fit``,
     ``predict`` on 2^20 held-out rows;
   - kNN: ``KNeighborsClassifier(n_neighbors=5).fit`` on the first 2^22
     standardized rows (512 MiB) with the fit's labels, ``predict`` on 2^13
     held-out standardized rows; then ``spatial.nearest_neighbors`` at
     k = 100 (above the kernel's shared-memory lists) on the same data;
   - kernel ridge: ``K = rbf(X, X, sigma=sqrt(32)) + eye(1024)`` over the
     first 1024 standardized rows, ``L = cholesky(K)``, then
     ``alpha = solve_triangular(L.T, solve_triangular(L, y, lower=True))``;
   - the array surface on the KMeans path's standardized z (2^24 x 32):
     ``abs``, ``>``, ``any``, ``sum``, ``clip``, ``where``, ``min``/``max``/
     ``argmin``/``argmax`` along axis 0, ``exp``, ``log1p``, ``sqrt``,
     ``sin``, ``//``, ``%`` and ``cumsum`` (on 2^20 rows), held against
     numpy (exact, or within SURFACE_ULPS of the float64 value on 2^16 rows,
     or cumsum's rounding bound), with one kernel launch, the cumsum's
     ``scan_axis``;
   - the public ``linalg.cholesky`` of a matrix that is not positive
     definite, through the kernel: jnp's NaN pattern;
   - and a wide fit beside the paths: ``KMeans(16, max_iter=10,
     tol=None).fit`` on 16 blobs of n = 2^20 rows x f = 160, which takes
     ``lloyd_fused``'s general route, held against the plain fit;
   - tall-skinny ``linalg.qr`` + ``matmul`` (the ``BASELINE.json`` ladder's
     last rung): A = 2^24 x 64 float32, split=0; the route taken
     (``qr.cholqr2`` or ``qr.householder``), float64 residuals, R against
     ``torch.linalg.qr``'s, times against ``torch.linalg.qr`` and
     ``torch.matmul``.
   - ``[spectral]`` (after phase 5): ``Spectral(n_clusters=4, gamma=1,
     n_lanczos=300)`` fit and predict on 4 blobs of 30000 x 18 (``bench.py``'s
     cdist size) drawn with ``ht.random``; each of its three kernels on the
     path's own inputs against its plain version (the moments of x, the
     normal draw and the k-means++ draws bit for bit, Lloyd on the
     embedding from the init's and the fitted centres); the same path
     through the plain versions (z within its bound, labels up to a
     permutation, Ritz values, and the plain path's Ritz pairs against this
     path's L), float64 Ritz residuals, per-step times;
   - ``[linalg]``: ``solve`` at n = 2048 and 16384, ``inv``, ``det`` (and an
     exact 0 for a zero column), ``cg`` on the ridge K, ``svd``/``rsvd``/
     ``lstsq``/``pinv`` at 2^22 x 64, each against float64 or a second
     route, timed beside the library call.
   - ``[robust]``: robust clustering of heavy-tailed data at 2^24 x 32
     (8 blobs and 2^18 uniform outlier rows joined by ``concatenate``):
     ``percentile``/``median`` along axis 0 against numpy's order
     statistics, robust scaling, the outlier clip by mask assignment,
     ``average``/``skew``/``kurtosis``/``cov``/``histogram``, ``KMedians``
     (centres equal ``np.median`` of the final members) and ``KMedoids``,
     ``unique``/``bincount``, ``topk``, ``reshape`` + ``sort`` + back; its
     two kernels on the path's own inputs; the plain path's labels equal.
5. Timing with CUDA events (median of single launches after warm-up; the
   repetitions are named per kernel): kernel, plain version, one-call
   library yardstick where one exists, and the bound of each kernel at its
   main-path shape (bytes over 3.35 TB/s or float32 flops over 67
   TFLOP/s). ``[design]`` lines name each redesigned kernel's launch plan.
   ``scan_axis`` (the port's own kernel behind cumsum/cumprod, see
   :func:`scan_phase`) at (2^24, 32) along axes 0 and 1, float32, int32
   and int64, against its plain version and a float64 scan, beside
   ``torch.cumsum``. The surface's calls (its cumsum through
   ``scan_axis``) are counted on their own: the rows carry
   ``launches_surface``.

6. ``[dist]``: the main path across every visible card, one process per
   card (spawned after the build, NCCL, no gloo fallback), 2^24 x 32 rows
   per card from one seed: ``mean``/``std`` -> standardize -> ``KMeans.fit``
   -> ``predict`` -> kNN ``predict`` (2^13 split-0 queries) -> ``qr`` +
   ``matmul(A.T, A)`` at 2^24 x 64 per card -> a resplit round trip ->
   the kernel-ridge path at 4096 rows per card (X of n x 32 drawn at
   split 0 and standardized, ``K = rbf(X, X)``, ``+ eye(n, split=0)``,
   ``cholesky(K, tiles_per_proc=4)``, whose 1024-wide diagonal blocks run
   ``chol_panel_fused`` on every rank above one card, and two
   ``solve_triangular``); per rank its launches, ``COLLECTIVES`` and
   times, the ridge residuals computed across ranks (L never gathered)
   and ``rbf(..., use_ring=True)`` against the default route; ``solve``
   on that K (the distributed LU), ``det``/``inv`` of a matrix with a known
   determinant, ``cg`` and ``lanczos(300)`` on K, ``svd``/``lstsq`` at 2^22
   x 64 per card (and ``lstsq``'s QR route at 2^20 rows per card), the
   spectral path on [spectral]'s data; then the
   same paths in this process on the same global data as the reference
   (the ridge factor against the one-process factor of the same K), and
   the weak-scaling efficiency of the warm fit; then ``[robust]``'s steps at
   2^24 x 32 per card (the split-axis sort receiving at most 3x each
   rank's share, percentiles by the key-bisection selection, cross-rank writes,
   KMedians) against one process on the same data; then the stream path:
   a save of 2^24 x 32 blobs from every rank (each writes its rows), a
   split-0 load (each reads only its rows), ``StreamingMoments`` and
   ``StreamingKMeans`` (10 epochs) over a split-0 ``ChunkIterator`` with
   their collectives gated (two and one ``allreduce`` per chunk), and
   ``merge_processes`` of per-rank moments through ``tree_merge`` (log2 P
   rounds, bit-identical on every rank), against one card; last, the
   ragged-layout path at 2^24 x 32 rows per card (:func:`_dist_layout`:
   ``redistribute_`` to the (0.40, 0.30, 0.20, 0.10) map and to the
   empty-shard (0.50, 0.25, 0.25, 0) map, standardize in place, ``z + y``
   from the head-skewed layout, cumsum/nonzero/sum/max/copy/astype,
   ``KMeans.fit`` with its one rebalance; every step gated on its
   rebalances and moves, every move on the bytes received; labels against
   the ceil-div fit's), then ring and Ulysses attention, ``halo_exchange``,
   ``ring_map``/``ring_reduce`` and ``bucket_move``. ``--phases dist``
   runs only phases 1, 2 and 6; ``--phases spectral``, ``linalg``,
   ``robust``, ``dtypes``, ``stream`` or ``layout`` only 1, 2 and that
   phase.
7. ``[stream]`` (after ``[dtypes]``, before ``[dist]``): the out-of-core path
   at 2^24 x 32 float32 (2 GiB) on one card, see :func:`stream_phase`.
8. ``[layout]`` (after ``[stream]``, before ``[dist]``): ``moments_onepass``
   and ``lloyd_fused`` at the row counts a ragged layout hands them (0
   among them: no launch, the neutral state), the attentions at world size
   1 on (8, 2^15, 128) against float64, tiles and flatmove on 2^24 x 32;
   see :func:`layout_phase`. The kernels' rows of the JSON line carry
   ``launches_layout``: rank 0's launches on ``[dist]``'s layout path.
9. ``[train]`` (after ``[layout]``, before ``[dist]``): the ML long tail and
   the training path on one card: ``entry()``'s Lloyd step at 2^24 x 32 (one
   ``lloyd_fused`` launch, against the plain step), GaussianNB on 2^24 x 32
   blobs (``moments_onepass`` in its variance smoothing; statistics against
   float64 and the plain path), Lasso at 10^7 x 65 against float64
   coordinate descent, one epoch of an MNIST-shaped CNN through
   ``MNISTDataset``/``DataLoader`` (shuffled)/``DataParallel`` (20 steps against a
   plain torch loop, a checkpoint round trip), and the ring and Ulysses
   attention gradients at (8, 2^15, 128) against float64; see
   :func:`train_phase`. The kernels' rows carry ``launches_train``.
   ``[dist]`` ends with the same steps across the cards
   (:func:`_dist_train`): DataParallel over the epoch split by rank
   (parameters bit-identical after every step, within DP_RTOL of one card's
   run on the global batches), DASO's diverge-and-meet and schedule at an
   even world size >= 4, GaussianNB at 2^24 x 32 and Lasso at 10^7 rows a
   card against one process, the attention gradients against float64, and
   ``entry.dryrun_body``.

10. ``[frame]`` (after ``[train]``, before ``[resilience]``): TPC-H's lineitem
   and orders at SF 10 made with numpy from the seed: the Q6-shaped filter,
   groupby(l_orderkey) over 1.5e7 groups in range and in hash mode,
   value_counts, the inner and left joins, the cluster profile (the kernels'
   rows carry ``launches_frame``) and StreamingGroupBy; see
   :func:`frame_phase`. ``[resilience]`` (before ``[dist]``): checkpoints of
   2 GiB with crc32 and sha256, torn writes and corruption, fingerprint,
   health_check and a straggler under ``deadlines``; see
   :func:`resilience_phase`. ``[dist]`` ends with the same frame steps on
   each rank's rows (:func:`_dist_frame`) and checkpoints across world sizes
   and a divergence entered on the last rank (:func:`_dist_resilience`).

11. ``[serve]`` (after ``[resilience]``, before ``[dist]``): the KMeans fit
   supervised on the main path's 2^24 x 32 blobs (clean, and restored from
   a checkpoint after three faults at step 3), then a ``ServeService`` of
   the KMeans and a kNN classifier on 2^22 rows playing a 4096-request
   open-loop trace batched and unbatched (every row against the models'
   own ``predict``), ``topk_distance`` at each serve bucket, the fault
   drills and clean monitor ticks; see :func:`serve_phase`. The kernels'
   rows carry ``launches_serve``. ``[dist]`` ends with :func:`_dist_serve`:
   a supervised fit that loses a rank, and the service across the cards
   through a lost rank and a flapping card.
12. ``[lazy]`` (after ``[serve]``, before ``[dist]``): heat_tpu's captured
   chains on the main path's 2^24 x 32 float32 blobs, split 0, through
   ``ht.lazy()`` (their elementwise runs in ``lazy_fused``), the
   standardized result into KMeans.fit, and a ServeService of an
   ``@ht.fuse`` endpoint warm across its buckets; each segment against
   ``lazy_fused_plain``, fused against eager, cold and warm host seconds,
   the warm call's budget, launches per chain (``score``'s sum fused into
   its segment: two launches, the segment and its partials' fold;
   ``cumsum``'s scan through ``scan_axis``, a launch a pass); a
   ``[design] lazy_fused`` line a segment (each input's route: ``bulk``
   copies, a ``tile`` filled once a block, or per-thread ``flat``/
   ``strided`` loads; the tile, ring stages, shared memory, blocks per SM,
   grid, and the kernel's ptxas registers and stack frame); the sweep of
   1-32 add/mul instructions with 0-2 broadcast rows as ``[time]`` lines
   (each program bit for bit at a tail size); the warm host microseconds
   of one call at the 1- and 256-row serve buckets; see
   :func:`lazy_phase`. It appends the
   ``lazy_fused`` row to the kernels line, and the other rows carry
   ``launches_lazy``. ``[dist]`` runs :func:`_dist_lazy` before
   ``_dist_serve``: a lazy chain with a split-axis reduction inside
   ``lockstep()``, and a divergence scheduled on rank 1 that raises
   ``LockstepError`` on every rank.

The line before last is one JSON object ``{"kernels": [...]}`` (not
printed with ``--phases dist``); the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
import argparse
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# ---- tolerances, kernel vs plain version on the same inputs (float32) ------
# The kernel and its plain version add the same terms in different orders
# (per-block partials merged in a fixed tree on the card vs torch's own
# reductions), and the moments kernel sums in float64 where the plain
# version sums in float32. The bounds are float32 reassociation bounds, the
# ones heat_tpu's parity tests state for the same functions.
MEAN_RTOL, MEAN_ATOL = 2e-6, 2e-6   # mean: one rounding of s1 / n
M2_RTOL = 2e-4                      # M2: s2 - s1^2/n loses a few bits in float32
SUMS_RTOL = 1e-5                    # sums: relative to the largest |sum|
INERTIA_RTOL = 1e-4                 # inertia: one sum over all rows
TIE_RTOL = 1e-5                     # labels may differ only where the two smallest d2 are this close
CENTERS_RTOL = 1e-4                 # fitted centroids, kernel fit vs plain fit, relative to max |c|
# kNN: distances as heat_tpu's own kNN tests hold them. An index may differ
# from the plain version's only as far as float32 rounding of
# d2 = (|x|^2 + |y|^2) - 2 x.y lets two rows trade places. Both evaluate that
# formula, each in its own order; behind one d2 stand at most f + 2 roundings
# in a chain (one per product, f - 1 per sum of f terms, one for the add, one
# for the subtract), so (Higham, Accuracy and Stability of Numerical
# Algorithms, 2nd ed., sec. 3.1) each computed d2 is within
#   E(x, y) = gamma_{f+2} (|x|^2 + |y|^2 + 2 sum_i |x_i y_i|) <= gamma_{f+2} (|x| + |y|)^2
# of the exact one, gamma_n = n u / (1 - n u), u = 2^-24 (the clamp at 0 only
# moves d2 toward the exact value). If the kernel ranks row i_r r-th and the
# plain version row i0_r, then at least r + 1 rows (the plain list's first)
# have kernel values within 2 max E of the plain list's r-th value, so the
# exact distances obey
#   |D(i_r) - D(i0_r)| <= E(x, y_{i_r}) + E(x, y_{i0_r}) + 2 max_{j in either list} E(x, y_j).
# knn_check computes D in float64 and this bound per row from the norms.
KNN_RTOL, KNN_ATOL = 1e-4, 1e-5
F32_UNIT_ROUNDOFF = 2.0 ** -24
# Cholesky, kernel vs plain version: the same steps with float32 sums of up
# to n terms in another order (fmaf chains vs cuBLAS), relative to max |L|
CHOL_ATOL_REL = 2e-5
# kernel ridge: ||L L^T - K||max / ||K||max is float32 Cholesky's backward
# error, c n eps ~ 1e-4 at n = 1024 in the worst case; ||K a - y|| / ||y|| is
# that error times the condition of K (at most 1 + ||rbf|| ~ 1e3 here)
RIDGE_RECON_RTOL = 1e-4
RIDGE_SOLVE_RTOL = 1e-2
# qr, float64 residuals of the float32 factors: ||QR - A||max/||A||max and ||QᵀQ - I||max (what heat_tpu's
# qr tests hold), R against torch.linalg.qr's R after normalizing row signs, relative to max |R|; the
# float32 Gram AᵀA over 2^24 rows against the float64 one, relative to its largest entry (a sum's rounding
# grows like u sqrt(m) for random signs: 2^-24 * 2^12 = 2.4e-4)
QR_RESID_RTOL, QR_ORTHO_ATOL, QR_R_RTOL = 1e-5, 1e-4, 1e-4
QR_GRAM_RTOL = 1e-3
# threefry_bits' normal draw, kernel vs plain version: both round every product and sum on its own and call
# CUDA's log1pf and sqrtf, so equal bits are expected; held within 2 float32 ulp
THREEFRY_NORMAL_RTOL = 2 * 2.0 ** -23
# the surface's float functions against their float64 values, in float32 ulps: CUDA's expf and sinf are
# within 2 ulp, log1pf within 1, sqrtf and floor exact, and z % 1 one rounding of an exact value
SURFACE_ULPS = 2.0

# ---- the card's peaks (NVIDIA H100 SXM data sheet) --------------------------
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

N_MAIN, F_MAIN, K_MAIN, ITERS = 1 << 24, 32, 8, 30
N_PREDICT = 1 << 20
N_TRAIN, N_QUERY, KNN_K = 1 << 22, 1 << 13, 5  # kNN path
N_RIDGE = 1024                                 # kernel-ridge path: heat_tpu's MAX_FUSED_N
N_WIDE, F_WIDE, K_WIDE, ITERS_WIDE = 1 << 20, 160, 16, 10  # the wide fit: lloyd_fused's general route
N_QR, F_QR = 1 << 24, 64    # tall-skinny qr: bench.py's QR_F at 16x its QR_N rows (4 GiB float32)
QR_CHUNK = 1 << 22           # rows per float64 check chunk
# CholeskyQR2 as qr.py writes it reads or writes an (m, n) array 7 times: per pass the Gram (read), the
# triangular solve (read, write); then the guard's Gram of Q (read)
QR_CHOLQR2_PASSES = 7
N_SLICE, N_CUMSUM = 1 << 16, 1 << 20  # the surface: rows compared with numpy, rows of the cumsum
THREEFRY_KEY = (0x2545F491, 0x6C078965)  # the phase-3 checks' key
# float32 operations per element of the normal draw: the uniform's subtract, multiply and add, u * u, log1p
# (counted as 10), a sqrt, a subtract, 9 multiply-adds of Horner's rule and two products; the ~70 32-bit
# integer operations of threefry's rounds have no peak in the table and are not counted
THREEFRY_NORMAL_FLOP = 36
# 32-bit integer operations per element of csrc/threefry.cu: the hash's 2 initial key adds, 20 rounds of an
# add, a constant rotate (one funnel shift) and an xor, and 5 key injections of two adds (2 + 60 + 10 = 72),
# then the float kinds' xor, shift and or (3); index and loop arithmetic are not counted. The H100 issues 64
# INT32 operations per clock per SM (16 per sub-partition), at the SM count and maximum SM clock of this card
THREEFRY_INT32_OPS = 75
INT32_OPS_PER_CLOCK_PER_SM = 64

# ---- [spectral]: spectral clustering at bench.py's cdist size (CDIST_N x CDIST_F: (n, n) float32 = 3.6 GB)
N_SPEC, F_SPEC, K_SPEC, N_LANCZOS = 30000, 18, 4, 300
SPEC_SEED, SPEC_KMEANS_SEED = 11, 12
# The blob centres are SPEC_SCALE times the rows of columns 1-3 of the 4 x 4 Hadamard matrix, tiled over the 18
# features: every feature splits the blobs two against two, every pair of centres differs in 12 features. After
# standardizing, each feature's variance is ~1 + SPEC_SCALE^2 = 37, so a point's noise is 1/sqrt(37) per feature:
# two points of one blob lie ~2 * 18 / 37 = 0.97 apart in d^2, two centres 12 * (2 * 6)^2 / 37 = 46.7. gamma = 1
# puts within-blob similarities exp(-gamma d^2) at O(1) (exp(-0.97) = 0.38 typical), and the closest points of
# two blobs (the centre distance less two noise radii) far below 1e-3; the phase measures both and checks them
SPEC_SCALE, SPEC_GAMMA = 6.0, 1.0
SPEC_WITHIN_MIN, SPEC_BETWEEN_MAX = 0.1, 1e-3  # median within-blob similarity, largest between-blob similarity
SPEC_ACC = 0.999
# Ritz values, kernel path vs plain path: the two paths' data differ by <= 2 ulp (the normal draws) and their
# standardization within the moments' bounds, which moves L by ~1e-6; a float32 Lanczos run adds ~eps ||L|| per
# step (||L|| <= 2 for norm_sym), ~4e-5 over 300 steps at worst: 1e-4
RITZ_ATOL = 1e-4
# float64 ||L v - theta v|| / ||L|| of a Ritz pair from the port's float32 V and T: the recurrence's rounding,
# eps ||L|| per step over m = 300 steps (3.6e-5 at worst), plus the pair's convergence; 1e-3 is ~30x that. The
# same bound holds a Ritz pair of one path's L against another path's L of the same data: the two L differ by
# the standardization's rounding (the moments' bounds below, ~1e-6 of ||L||), far inside it, while a
# standardization off by a few percent moves every similarity exp(-gamma d^2) by that share of gamma d^2
RITZ_RESID_RTOL = 1e-3
# z of the kernel path against z of the plain path (same x, bit-identical draws): z = (x - mu) / sigma with mu
# within MEAN_ATOL + MEAN_RTOL |mu| and M2 within M2_RTOL (so sigma within M2_RTOL / 2, relative) of the
# plain moments, and two float32 roundings on each side: |dz| <= (MEAN_ATOL + MEAN_RTOL |mu|) / sigma
# + |z| M2_RTOL / 2 + 4 u |z|

# ---- [linalg]: the rest of linalg at full width on one card
SOLVE_NS = (2048, 16384)  # bench.py's SOLVE_N, and a 1 GiB system
N_DET, N_INV = 2048, 2048
N_CG = 1024               # the kernel-ridge path's n
N_SVD, F_SVD, RSVD_RANK, RSVD_OVERSAMPLES = 1 << 22, 64, 16, 10
LINALG_SEED = 13
# svd: Householder-based SVDs are backward stable, ||dA|| <= p(m, n) u ||A|| with p growing like n in practice
# (64 u = 3.8e-6 at n = 64): ||A - U S Vh||_F / ||A||_F <= 1e-4, and two such SVDs' singular values within
# 2e-4 of the largest (Weyl)
SVD_RESID_RTOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def knn_check(x, y, d, i, d0, i0):
    """Distances within KNN_RTOL/KNN_ATOL, and every index that differs from
    the plain version's within the rounding bound derived above; returns (max
    abs distance error, differing entries, largest |D(i_r) - D(i0_r)| / bound)."""
    import torch

    e = (d - d0).abs()
    check(bool((e <= KNN_ATOL + KNN_RTOL * d0.abs()).all()), f"kNN distances differ by up to {e.max().item()}")
    diff = i != i0
    rows = torch.nonzero(diff.any(dim=1)).flatten()
    nr = (x.shape[1] + 2) * F32_UNIT_ROUNDOFF
    gamma = nr / (1 - nr)
    worst = 0.0
    for r0 in range(0, rows.numel(), 256):
        rr = rows[r0 : r0 + 256]
        xr = x[rr].double().unsqueeze(1)                          # (R, 1, f)
        yk, yp = y[i[rr].long()].double(), y[i0[rr].long()].double()  # (R, k, f)
        gap = (((xr - yk) ** 2).sum(-1) - ((xr - yp) ** 2).sum(-1)).abs()  # exact distances, float64
        nx = xr.norm(dim=2)
        ek, ep = gamma * (nx + yk.norm(dim=2)) ** 2, gamma * (nx + yp.norm(dim=2)) ** 2
        bound = ek + ep + 2 * torch.maximum(ek.amax(1, keepdim=True), ep.amax(1, keepdim=True))
        check(bool((gap <= bound).all()), "kNN indices differ beyond float32 rounding of the distances")
        worst = max(worst, (gap / bound).max().item())
    return e.max().item(), int(diff.sum()), worst


def time_ms(fn, reps=25, warm=3):
    """The median of ``reps`` single calls after ``warm`` unmeasured ones,
    between CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # keep the card busy while the host enqueues: times the device, not the launch
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ulps(r, ref64):
    """|r - ref64| in units of the float32 spacing at ref64 (NaN where both
    are NaN; inf where only one is)."""
    import numpy as np

    r = r.astype(np.float64)
    both = np.isnan(r) & np.isnan(ref64)
    err = np.abs(r - ref64) / np.spacing(np.abs(ref64).astype(np.float32)).astype(np.float64)
    err[np.isnan(r) != np.isnan(ref64)] = np.inf
    return np.where(both, 0.0, err)


def spd(n, gen, dev):
    import torch

    g = torch.randn(n, n, device=dev, generator=gen, dtype=torch.float64)
    return (g @ g.T / n + torch.eye(n, device=dev, dtype=torch.float64)).to(torch.float32)


def spectral_centres(dev):
    """[spectral]'s K_SPEC x F_SPEC blob centres (see SPEC_SCALE)."""
    import torch

    hadamard = torch.tensor([[1.0, 1.0, 1.0], [-1.0, 1.0, -1.0], [1.0, -1.0, -1.0], [-1.0, -1.0, 1.0]])
    return (hadamard[:, torch.arange(F_SPEC) % 3] * SPEC_SCALE).to(dev)


def spectral_data(ht):
    """[spectral]'s data, the same global arrays at any world size (split draws are split-invariant): the blob of
    each of N_SPEC rows (``randint``) and x = its centre + ``randn``, both split 0."""
    ht.random.seed(SPEC_SEED)
    member = ht.random.randint(0, K_SPEC, size=(N_SPEC,), split=0, dtype=ht.int64)
    centres = spectral_centres(member.larray.device)
    x = ht.random.randn(N_SPEC, F_SPEC, split=0) + ht.DNDarray(centres[member.larray], gshape=(N_SPEC, F_SPEC), split=0)
    return member, x


def spectral_fit(ht, z, seen=None):
    """[spectral]'s estimator, fitted on z. ``seen``, where given, receives the inputs of the fit's Lloyd
    launches: the embedding KMeans is fitted on (``"embedding"``) and the centres its k-means++ init draws
    (``"init"``)."""
    sp = ht.cluster.Spectral(n_clusters=K_SPEC, gamma=SPEC_GAMMA, n_lanczos=N_LANCZOS, random_state=SPEC_KMEANS_SEED)
    if seen is not None:
        km = sp._cluster
        fit, init = km.fit, km._initialize_cluster_centers
        km.fit = lambda e: (seen.__setitem__("embedding", e), fit(e))[1]
        km._initialize_cluster_centers = lambda e: seen.setdefault("init", init(e))
    return sp.fit(z)


def matched_labels(labels, truth, k, comm=None, what="labels"):
    """(share, perm): ``perm[t]`` is the label value matched to truth value t (one to one, by the counts of the
    rows that carry both, summed across ranks), and ``share`` the share of rows the match agrees on."""
    import torch

    cont = torch.zeros(k, k, dtype=torch.float64, device=labels.device)
    cont.index_put_((truth.long(), labels.long()), torch.ones_like(labels, dtype=torch.float64), accumulate=True)
    if comm is not None:
        cont = comm.allreduce(cont)
    perm = cont.argmax(dim=1)
    check(len(set(perm.tolist())) == k, f"{what}: no one-to-one match of the clusters, counts {cont.tolist()}")
    return (cont[torch.arange(k), perm].sum() / cont.sum()).item(), perm


def ritz_residuals(L_rows, start, Y, theta, l_norm, comm=None):
    """float64 ||L y - theta y|| / (||L||_2 ||y||) of the Ritz pairs (theta_j, y_j), Y's columns (Y and theta
    replicated; Y = V @ T's eigenvectors); L_rows are this rank's rows of L from global row ``start``.
    ``l_norm`` is the largest |Ritz value| of the Lanczos run, at most ||L||_2, which it stands in for, so the
    ratios are upper bounds."""
    import torch

    Y = Y.double()
    rows = L_rows.shape[0]
    R = torch.empty((rows, Y.shape[1]), dtype=torch.float64, device=Y.device)
    for r0 in range(0, rows, 2048):
        R[r0 : r0 + 2048] = L_rows[r0 : r0 + 2048].double() @ Y
    R -= Y[start : start + rows] * theta.double()
    num2 = (R * R).sum(dim=0)
    if comm is not None:
        num2 = comm.allreduce(num2)
    return (num2.sqrt() / (float(l_norm) * Y.norm(dim=0))).tolist()


def known_det_matrix(n, dev, seed):
    """(a, det): a = Q diag(d) Q^T in float32, Q orthogonal (the QR of a float64 Gaussian matrix), |d| in
    [e^-1, e] with sum log|d| = 10 and an odd number of negative d, so det(Q diag(d) Q^T) = -e^10 (finite in
    float32) and cond(a) <= e^2; ``det`` is the float64 determinant of the float32 matrix a (its rounding moves
    the determinant by ~n u). Every rank that calls it with the same seed on the same card model gets the same a."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.linalg.qr(torch.randn(n, n, device=dev, generator=g, dtype=torch.float64)).Q
    logs = torch.rand(n, device=dev, generator=g, dtype=torch.float64) * 2 - 1
    logs = logs - logs.mean() + 10.0 / n
    sign = torch.ones(n, device=dev, dtype=torch.float64)
    sign[: 2 * (n // 4) + 1] = -1.0  # an odd count
    a = ((q * (sign * logs.exp())) @ q.T).to(torch.float32)
    del q
    return a, torch.linalg.det(a.double()).item()


def spectral_kernel_checks(ht, dev, x, member, emb, init, sp):
    """[spectral]'s three kernels on the path's own inputs, each against its plain version with phase 3's
    tolerances: ``moments_onepass`` on x (N_SPEC x F_SPEC); ``threefry_bits``' normal draw of x at the path's key
    and the k-means++ init's draws, bit-identical; ``lloyd_fused`` on the (N_SPEC, K_SPEC) embedding from the
    init's centres (the path's first launch, whose labels are ``labels_``) and from the fitted centres (its
    last, whose inertia is ``inertia_``). Returns the lines to print."""
    import numpy as np
    import torch

    from heat_tpu_torch.core import random as ht_random
    from heat_tpu_torch.core.kernels import (
        THREEFRY_KERNEL, assign_stats, chunk_moments, forced_mode, lloyd_local, moments_local, threefry_bits,
        threefry_plain,
    )
    from heat_tpu_torch.core.kernels.threefry import chunk_layout
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    lines = []
    xa = x.larray
    cnt, mean, m2 = moments_local(xa, N_SPEC)
    cnt0, mean0, m20 = chunk_moments(xa, N_SPEC)
    check(float(cnt) == float(cnt0) == float(N_SPEC), f"[spectral] moments counts {float(cnt)} vs {float(cnt0)}")
    e_mean, e_m2 = (mean - mean0).abs(), (m2 - m20).abs()
    check(bool((e_mean <= MEAN_ATOL + MEAN_RTOL * mean0.abs()).all()), f"[spectral] moments mean: {e_mean.max().item()}")
    check(bool((e_m2 <= M2_RTOL * m20.abs() + 1e-6).all()), f"[spectral] moments M2: {e_m2.max().item()}")
    lines.append(f"moments_onepass on the path's x {tuple(xa.shape)}: count exact, mean max abs {e_mean.max().item():.3e}, "
                 f"M2 max rel {(e_m2 / m20.abs()).max().item():.3e} (<= {M2_RTOL})")

    # the path's normal draw: seed SPEC_SEED, after randint's N_SPEC elements, as _float_draw makes it
    ht.random.set_state(("Threefry", SPEC_SEED, N_SPEC))
    key = ht_random._next_key(N_SPEC * F_SPEC)
    layout = ht_random._chunk((N_SPEC, F_SPEC), 0, x.comm)[2]
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    args = (layout, "normal32", dev, float(lo), float(np.float32(1.0) - lo))
    drawn = threefry_bits(key, *args).reshape(N_SPEC, F_SPEC)
    check(torch.equal(drawn + spectral_centres(dev)[member.larray], xa), "[spectral] the recomputed draw is not the path's x")
    check(torch.equal(drawn, threefry_plain(key, *args).reshape(N_SPEC, F_SPEC)),
          "[spectral] threefry_bits' normal draw differs from its plain version")
    # the k-means++ init's draws (random_state SPEC_KMEANS_SEED): randint's two 64-bit words for the first centre,
    # one float32 uniform for each next one; and the init itself, with threefry_bits and with its plain version
    ikey = ht_random._fold_in(ht_random._prng_key(SPEC_KMEANS_SEED), 0)
    one = chunk_layout((), None, 0, 0)
    draws = [(k, "bits64") for k in ht_random._split(ht_random._fold_in(ikey, 0))]
    draws += [(ht_random._fold_in(ikey, i), "uniform32") for i in range(1, K_SPEC)]
    for k, kind in draws:
        check(torch.equal(threefry_bits(k, one, kind, dev), threefry_plain(k, one, kind, dev)),
              f"[spectral] the k-means++ {kind} draw differs from its plain version")
    km = ht.cluster.KMeans(n_clusters=K_SPEC, init="probability_based", random_state=SPEC_KMEANS_SEED)
    init_k = km._initialize_cluster_centers(emb)
    with forced_mode(THREEFRY_KERNEL, "torch"):
        init_p = km._initialize_cluster_centers(emb)
    check(torch.equal(init_k, init) and torch.equal(init_p, init), "[spectral] k-means++ centres differ from the path's")
    lines.append(f"threefry_bits: the path's normal draw {(N_SPEC, F_SPEC)} (x = draw + centres, bit for bit) and "
                 f"the k-means++ init's {len(draws)} draws bit-identical to the plain version; the init's centres "
                 f"equal the path's on both")

    ea = emb.larray
    for name, cen in (("init", init), ("fitted", sp._cluster.cluster_centers_.larray)):
        sums, counts, labels, inertia = lloyd_local(ea, cen, N_SPEC)
        sums0, counts0, labels0, inertia0 = assign_stats(ea, cen, N_SPEC)
        check(bool((counts == counts0).all()), f"[spectral] lloyd counts from the {name} centres")
        two = torch.topk(_quadratic_expand(ea, cen), 2, dim=1, largest=False).values
        near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
        diff = labels != labels0
        check(not bool((diff & ~near).any()), f"[spectral] lloyd labels from the {name} centres differ outside near-ties")
        e_sums = (sums - sums0).abs().max().item()
        check(e_sums <= SUMS_RTOL * sums0.abs().max().item(), f"[spectral] lloyd sums from the {name} centres: {e_sums}")
        e_in = abs(float(inertia) - float(inertia0))
        check(e_in <= INERTIA_RTOL * abs(float(inertia0)), f"[spectral] lloyd inertia from the {name} centres: {e_in}")
        if name == "init":
            check(torch.equal(labels.long(), sp.labels_.larray), "[spectral] the first Lloyd launch's labels are not labels_")
        else:
            check(float(inertia) == sp._cluster.inertia_, "[spectral] the last Lloyd launch's inertia is not inertia_")
        lines.append(f"lloyd_fused on the path's embedding {tuple(ea.shape)} from the {name} centres: counts exact, "
                     f"labels differ on {int(diff.sum())} rows ({int(near.sum())} near-tie rows), sums max abs "
                     f"{e_sums:.3e} (max |sum| {sums0.abs().max().item():.3e}), inertia rel "
                     f"{e_in / max(abs(float(inertia0)), 1e-30):.3e}")
    return lines


def spectral_phase(dev):
    """[spectral]: spectral clustering at N_SPEC x F_SPEC through its user-facing calls; its three kernels on the
    path's own inputs against their plain versions; the same path through the plain versions (z, labels, and
    the plain path's Ritz pairs against this path's L); then a per-step breakdown, the Ritz pairs' residuals,
    and the blobs' similarities behind the choice of gamma."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import LLOYD_KERNEL, MOMENTS_KERNEL, THREEFRY_KERNEL, forced_mode
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    ht.use_device("gpu")
    n_bytes = N_SPEC * N_SPEC * 4

    def run(seen=None):
        t = {}
        t0 = time.perf_counter()
        member, x = spectral_data(ht)
        torch.cuda.synchronize()
        t["draws"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mu, sd = ht.mean(x, axis=0), ht.std(x, axis=0)
        z = (x - mu) / sd
        torch.cuda.synchronize()
        t["standardize"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sp = spectral_fit(ht, z, seen)
        torch.cuda.synchronize()
        t["fit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = sp.predict(z)
        torch.cuda.synchronize()
        t["predict"] = time.perf_counter() - t0
        return member, x, (mu, sd, z), sp, pred, t

    seen = {}
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    member, x, (mu, sd, z), sp, pred, t_main = run(seen)
    launches, stats = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS)
    print(f"[spectral] launches {launches} KERNEL_STATS {stats}", flush=True)
    n_iter = sp._cluster.n_iter_
    check(launches["threefry_bits"] > 0 and stats.get("threefry_bits.cuda", 0) > 0,
          f"the draws and the k-means++ init should launch threefry_bits: {launches}")
    check(launches["moments_onepass"] == 1, f"one moments launch should serve mean and std: {launches}")
    check(launches["lloyd_fused"] == n_iter + 1 and stats.get("lloyd_fused.resident") == n_iter + 1,
          f"lloyd launches {launches['lloyd_fused']} != n_iter + 1 = {n_iter + 1}, or not resident: {stats}")
    check(not any(k.endswith(".torch") for k in stats), f"a plain version ran on the path: {stats}")
    lab, truth = sp.labels_.larray, member.larray
    check(sp.labels_.gshape == (N_SPEC,) and sp.labels_.split == 0 and pred.split == 0, "labels metadata")
    acc, _ = matched_labels(lab, truth, K_SPEC, what="labels vs the blobs")
    check(acc >= SPEC_ACC, f"spectral labels agree with the blobs on {acc} of the rows")
    check(torch.equal(pred.larray, lab), "predict on the fitted data differs from labels_")
    print(f"[spectral] n={N_SPEC} f={F_SPEC} k={K_SPEC} gamma={SPEC_GAMMA} n_lanczos={N_LANCZOS}: labels agree with "
          f"the blobs on {acc:.6f} of the rows; predict == labels_; KMeans on the embedding took {n_iter} Lloyd "
          f"iterations; first calls: draws {t_main['draws']:.4f} s, standardize {t_main['standardize']:.4f} s, "
          f"fit {t_main['fit']:.4f} s, predict {t_main['predict']:.4f} s", flush=True)
    for line in spectral_kernel_checks(ht, dev, x, member, seen["embedding"], seen["init"], sp):
        print(f"[spectral] {line}", flush=True)

    # the same path through the plain versions of the three kernels
    with forced_mode(THREEFRY_KERNEL, "torch"), forced_mode(MOMENTS_KERNEL, "torch"), forced_mode(LLOYD_KERNEL, "torch"):
        member0, x0, (mu0, sd0, z0), sp0, pred0, t_plain = run()
        evals0, V0, evecs0 = sp0._spectral_embedding(z0)
    check(torch.equal(member0.larray, truth) and torch.equal(x0.larray, x.larray), "the plain draws differ from the kernel's")
    u = F32_UNIT_ROUNDOFF
    za, z0a = z.larray, z0.larray
    z_bound = (MEAN_ATOL + MEAN_RTOL * mu0.larray.abs()) / sd0.larray + z0a.abs() * (M2_RTOL / 2 + 4 * u)
    e_z = (za - z0a).abs()
    check(bool((e_z <= z_bound).all()), f"z vs the plain path's beyond its bound: {(e_z / z_bound).max().item()} of it")
    same, _ = matched_labels(sp0.labels_.larray, lab, K_SPEC, what="labels vs the plain path's")
    check(same == 1.0, f"labels equal the plain path's up to a permutation on only {same} of the rows")

    # the steps one by one (the fit's own sequence), for their times; L stays for the residuals
    sigma = (1.0 / (2.0 * SPEC_GAMMA)) ** 0.5
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    S = step("rbf", lambda: ht.spatial.rbf(z, sigma=sigma))
    L = step("Laplacian", lambda: ht.graph.Laplacian(lambda _: S).construct(z))
    V, T = step("lanczos", lambda: ht.linalg.lanczos(L, N_LANCZOS))
    evals, evecs = step("eigh", lambda: torch.linalg.eigh(T.larray))
    step("KMeans fit", lambda: ht.cluster.KMeans(n_clusters=K_SPEC, init="probability_based",
                                                 random_state=SPEC_KMEANS_SEED).fit(
        ht.array(V.larray @ evecs[:, :K_SPEC], split=0)))
    e_ritz = (evals[:K_SPEC] - evals0[:K_SPEC]).abs().max().item()
    check(e_ritz <= RITZ_ATOL, f"Ritz values vs the plain path's: {e_ritz}")
    Y, Y0 = V.larray.double() @ evecs[:, :K_SPEC].double(), V0.double() @ evecs0[:, :K_SPEC].double()
    resid = ritz_residuals(L.larray, 0, Y, evals[:K_SPEC], evals.abs().max())
    check(max(resid) <= RITZ_RESID_RTOL, f"Ritz pairs' ||L v - theta v|| / ||L|| {resid}")
    # the plain path's Ritz pairs (from its own z and L) against this path's L
    resid_x = ritz_residuals(L.larray, 0, Y0, evals0[:K_SPEC], evals0.abs().max())
    check(max(resid_x) <= RITZ_RESID_RTOL, f"the plain path's Ritz pairs against this path's L: {resid_x}")
    # the two embeddings' spans: the sine of their largest principal angle
    cos_min = torch.linalg.svdvals(torch.linalg.qr(Y).Q.T @ torch.linalg.qr(Y0).Q).min().clamp(max=1.0).item()
    sin_max = (1.0 - cos_min**2) ** 0.5
    e_next = (evals[K_SPEC : 2 * K_SPEC] - evals0[K_SPEC : 2 * K_SPEC]).abs().max().item()
    del S, L, V0, Y, Y0
    torch.cuda.empty_cache()

    # gamma: within-blob similarities (a sample of 4096 rows against all) and the largest between-blob one
    within, between = [], 0.0
    for r0 in range(0, N_SPEC, 4096):
        d2 = _quadratic_expand(za[r0 : r0 + 4096], za)
        same_blob = truth[r0 : r0 + 4096, None] == truth[None, :]
        between = max(between, torch.exp(-SPEC_GAMMA * d2[~same_blob].min()).item())
        if r0 == 0:
            within = torch.exp(-SPEC_GAMMA * d2[same_blob]).median().item()
        del d2, same_blob
    check(within >= SPEC_WITHIN_MIN and between <= SPEC_BETWEEN_MAX,
          f"gamma = {SPEC_GAMMA}: median within-blob similarity {within}, largest between-blob {between}")
    lanczos_bound = N_LANCZOS * n_bytes / HBM_BYTES_PER_S
    print(f"[spectral] gamma = {SPEC_GAMMA}: median within-blob similarity {within:.4f} (O(1)), largest "
          f"between-blob similarity {between:.3e} (< {SPEC_BETWEEN_MAX})", flush=True)
    print(f"[spectral] vs the plain path (threefry_bits, moments_onepass, lloyd_fused forced to their plain "
          f"versions): x bit-identical; z max abs diff {e_z.max().item():.3e} ({(e_z / z_bound).max().item():.3f} of "
          f"its bound); labels equal up to a permutation; {K_SPEC} smallest Ritz values max abs diff {e_ritz:.3e} "
          f"(<= {RITZ_ATOL}), the next {K_SPEC} {e_next:.3e}; Ritz values "
          f"{[round(v, 6) for v in evals[:K_SPEC + 1].tolist()]}; float64 ||L v - theta v|| / ||L|| of the "
          f"{K_SPEC} smallest pairs {[f'{r:.3e}' for r in resid]}, of the plain path's pairs against this path's L "
          f"{[f'{r:.3e}' for r in resid_x]} (<= {RITZ_RESID_RTOL}); sine of the largest principal angle between "
          f"the two embeddings {sin_max:.3e}; plain path first calls: fit {t_plain['fit']:.4f} s, predict "
          f"{t_plain['predict']:.4f} s", flush=True)
    print(f"[spectral] per step (host clock, warm shapes): draws {t_main['draws']:.4f} s, standardize "
          f"{t_main['standardize']:.4f} s, rbf {steps['rbf']:.4f} s (bound: writes {n_bytes} B, "
          f"{n_bytes / HBM_BYTES_PER_S:.5f} s), Laplacian {steps['Laplacian']:.4f} s, lanczos {steps['lanczos']:.4f} s "
          f"({steps['lanczos'] / N_LANCZOS * 1e3:.4f} ms per step; bound: L read once per step, "
          f"{lanczos_bound:.4f} s), eigh {steps['eigh']:.4f} s, KMeans fit {steps['KMeans fit']:.4f} s; the path's "
          f"fit {t_main['fit']:.4f} s and predict {t_main['predict']:.4f} s; whole path "
          f"{sum(t_main.values()):.4f} s", flush=True)


def linalg_phase(dev):
    """[linalg]: solve, det, inv, cg, svd, rsvd, lstsq and pinv at full width on one card, each against float64
    or a second route, with the bounds stated beside each gate, and timed beside the library call it makes."""
    import torch

    import heat_tpu_torch as ht

    ht.use_device("gpu")
    u = F32_UNIT_ROUNDOFF
    gen = torch.Generator(device=dev)
    gen.manual_seed(LINALG_SEED)
    ht.kernels.reset_kernel_stats()

    def first(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # solve on bench.py's split-0 SPD system, M/sqrt(n) (M/sqrt(n))^T + I; the gate is the normwise backward
    # error ||b - A x||_inf / (||A||_inf ||x||_inf + ||b||_inf) <= n u (LU with partial pivoting, growth O(1))
    for n in SOLVE_NS:
        m_ = torch.randn(n, n, device=dev, generator=gen) / n**0.5
        a_t = m_ @ m_.T + torch.eye(n, device=dev)
        del m_
        b_t = torch.randn(n, device=dev, generator=gen)
        A, b = ht.array(a_t, split=0, copy=False), ht.array(b_t, split=0, copy=False)
        x, t_first = first(lambda: ht.linalg.solve(A, b))
        check(x.gshape == (n,) and x.split is None and x.larray.is_cuda, f"solve metadata at n={n}")
        a64, x64 = a_t.double(), x.larray.double()
        eta = ((b_t.double() - a64 @ x64).abs().max() / (a64.abs().sum(1).max() * x64.abs().max()
                                                          + b_t.abs().max())).item()
        del a64
        check(eta <= n * u, f"solve backward error {eta} > n u = {n * u} at n={n}")
        ms, lib_ms = time_ms(lambda: ht.linalg.solve(A, b), reps=5, warm=1), time_ms(lambda: torch.linalg.solve(a_t, b_t), reps=5, warm=1)
        flop = 2 * n**3 / 3 + 2 * n * n
        print(f"[linalg] solve n={n} split 0: backward error {eta:.3e} (<= n u = {n * u:.3e}); first call "
              f"{t_first:.4f} s; ht.linalg.solve {ms:.4f} ms, torch.linalg.solve {lib_ms:.4f} ms on the same tensors "
              f"(at world size 1 the port calls torch.linalg.solve itself); 2/3 n^3 + 2 n^2 = {flop:.4e} flop, "
              f"bound at 67 TFLOP/s {flop / FP32_FLOP_PER_S * 1e3:.4f} ms", flush=True)
        if n == N_INV:
            # inv on the same matrix: ||A X - I||_max <= n u cond(A)
            X, t_inv = first(lambda: ht.linalg.inv(A))
            ev = torch.linalg.eigvalsh(a_t.double())
            kappa = (ev[-1] / ev[0]).item()
            r_inv = (a_t.double() @ X.larray.double() - torch.eye(n, device=dev, dtype=torch.float64)).abs().max().item()
            check(X.split == 0 and r_inv <= n * u * kappa, f"inv residual {r_inv} > n u cond = {n * u * kappa}")
            ms_i, lib_i = time_ms(lambda: ht.linalg.inv(A), reps=5, warm=1), time_ms(lambda: torch.linalg.inv(a_t), reps=5, warm=1)
            print(f"[linalg] inv n={n} split 0 (result split 0): ||A inv(A) - I||_max {r_inv:.3e} (<= n u cond(A) = "
                  f"{n * u * kappa:.3e}, cond {kappa:.3f}); first call {t_inv:.4f} s; ht.linalg.inv {ms_i:.4f} ms, "
                  f"torch.linalg.inv {lib_i:.4f} ms", flush=True)
            del X
        del A, b, a_t, b_t, x, x64
        torch.cuda.empty_cache()

    # context for [dist]'s LU at n = 16384 on four cards: the first panel every rank factors, (n, n / 4)
    from heat_tpu_torch.core.linalg.factorizations import _lu_factor

    pnl = torch.randn(SOLVE_NS[-1], SOLVE_NS[-1] // 4, device=dev, generator=gen)
    ms_default = time_ms(lambda: torch.linalg.lu_factor_ex(pnl), reps=3, warm=1)
    ms_panel = time_ms(lambda: _lu_factor(pnl), reps=3, warm=1)
    pf = SOLVE_NS[-1] * (SOLVE_NS[-1] // 4) ** 2 - (SOLVE_NS[-1] // 4) ** 3 / 3
    print(f"[linalg] LU of a {tuple(pnl.shape)} panel ([dist]'s first LU panel at four cards): the port's _lu_factor "
          f"(cuSOLVER getrf, its pivots read back) {ms_panel:.4f} ms; torch.linalg.lu_factor_ex with torch's default "
          f"library choice (MAGMA for a rectangular matrix) {ms_default:.4f} ms; {pf:.4e} flop, bound at 67 TFLOP/s "
          f"{pf / FP32_FLOP_PER_S * 1e3:.4f} ms", flush=True)
    del pnl

    # det of Q diag(d) Q^T: the relative change of a determinant under a backward error dA is at most
    # n ||A^-1|| ||dA|| <= n cond(A) u (first order, growth O(1)); cond <= e^2
    a_t, det64 = known_det_matrix(N_DET, dev, LINALG_SEED)
    d, t_det = first(lambda: ht.linalg.det(ht.array(a_t, split=0, copy=False)))
    bound = N_DET * math.e**2 * u
    e_det = abs(d.item() - det64) / abs(det64)
    check(d.gshape == () and d.split is None and math.isfinite(d.item()) and d.item() < 0 and e_det <= bound,
          f"det {d.item()} vs float64 {det64}: relative {e_det} > {bound}")
    ms_d, lib_d = time_ms(lambda: ht.linalg.det(ht.array(a_t, split=0, copy=False)), reps=5, warm=1), time_ms(lambda: torch.linalg.det(a_t), reps=5, warm=1)
    print(f"[linalg] det n={N_DET} of Q diag(d) Q^T (sum log|d| = 10, an odd number of d < 0): {d.item():.6e} vs "
          f"float64 {det64:.6e}, relative {e_det:.3e} (<= n e^2 u = {bound:.3e}); first call {t_det:.4f} s; "
          f"ht.linalg.det {ms_d:.4f} ms, torch.linalg.det {lib_d:.4f} ms", flush=True)
    # a zero column makes a pivot exactly zero: heat_tpu keeps its multipliers zero, so det is an exact 0
    a_t[:, 5] = 0.0
    d0 = ht.linalg.det(ht.array(a_t, split=0, copy=False)).item()
    check(d0 == 0.0, f"det of a matrix with a zero column is {d0}, not an exact 0")
    print(f"[linalg] det n={N_DET} with a zero column: {d0} (torch.linalg.det of the same tensor: "
          f"{torch.linalg.det(a_t).item()})", flush=True)
    del a_t

    # cg on the kernel-ridge path's K = rbf(X, X, sigma = sqrt(32)) + I over 1024 standardized rows, against its
    # Cholesky solve: x - alpha = K^-1 (r_x - r_alpha) and ||K^-1|| <= 1, so ||x - alpha|| <= ||r_x|| + ||r_alpha||
    ht.random.seed(LINALG_SEED)
    Xr = ht.random.randn(N_CG, F_MAIN, split=0)
    Xr = (Xr - ht.mean(Xr, axis=0)) / ht.std(Xr, axis=0)
    K = ht.spatial.rbf(Xr, Xr, sigma=F_MAIN ** 0.5) + ht.eye(N_CG)
    yv = ht.random.randn(N_CG, split=0)
    L = ht.linalg.cholesky(K)
    alpha = ht.linalg.solve_triangular(L.T, ht.linalg.solve_triangular(L, yv, lower=True), lower=False)
    xc, t_cg = first(lambda: ht.linalg.cg(K, yv, ht.zeros(N_CG)))
    k64, y64 = K.larray.double(), yv.larray.double()
    r_x, r_a = (k64 @ xc.larray.double() - y64).norm().item(), (k64 @ alpha.larray.double() - y64).norm().item()
    dx = (xc.larray.double() - alpha.larray.double()).norm().item()
    check(xc.split == 0 and r_x / y64.norm().item() <= RIDGE_SOLVE_RTOL and dx <= (r_x + r_a) * (1 + 1e-6),
          f"cg: ||K x - y|| {r_x}, ||x - alpha|| {dx} > ||r_x|| + ||r_alpha|| = {r_x + r_a}")
    ms_cg = time_ms(lambda: ht.linalg.cg(K, yv, ht.zeros(N_CG)), reps=3, warm=1)
    print(f"[linalg] cg n={N_CG} on the kernel-ridge K: ||K x - y||/||y|| {r_x / y64.norm().item():.3e}; "
          f"||x - alpha_cholesky|| {dx:.3e} (<= ||r_x|| + ||r_alpha|| = {r_x + r_a:.3e}); first call {t_cg:.4f} s, "
          f"warm {ms_cg:.4f} ms", flush=True)
    del K, L, alpha, xc, k64, Xr

    # svd, rsvd, lstsq, pinv at N_SVD x F_SVD split 0: A = G diag(s) W, s from 1 down to 1e-2 (cond ~100)
    g_t = torch.randn(N_SVD, F_SVD, device=dev, generator=gen) / N_SVD**0.5
    w = torch.linalg.qr(torch.randn(F_SVD, F_SVD, device=dev, generator=gen, dtype=torch.float64)).Q
    s_true = torch.logspace(0, -2, F_SVD, device=dev, dtype=torch.float64)
    a_t = (g_t.double() * s_true @ w).to(torch.float32)
    A = ht.array(a_t, split=0, copy=False)

    def chunks(t=a_t):
        for r0 in range(0, N_SVD, 1 << 20):
            yield r0, t[r0 : r0 + (1 << 20)].double()

    a_f = math.sqrt(sum((c * c).sum().item() for _, c in chunks()))
    (U, S, Vh), t_svd = first(lambda: ht.linalg.svd(A))
    check(U.split == 0 and S.split is None and Vh.split is None and U.gshape == (N_SVD, F_SVD), "svd metadata")
    s_lib = torch.linalg.svdvals(a_t)
    us = (U.larray * S.larray).double()
    e_rec = math.sqrt(sum(((us[r0 : r0 + c.shape[0]] @ Vh.larray.double() - c) ** 2).sum().item() for r0, c in chunks())) / a_f
    e_s = (S.larray - s_lib).abs().max().item()
    s_max = s_lib.max().item()
    check(e_rec <= SVD_RESID_RTOL and e_s <= 2 * SVD_RESID_RTOL * s_max,
          f"svd: ||A - U S Vh||_F/||A||_F {e_rec}, S vs svdvals {e_s}")
    del us
    kappa = (s_lib.max() / s_lib.min()).item()
    ms_svd = time_ms(lambda: ht.linalg.svd(A), reps=3, warm=1)
    ms_lib = time_ms(lambda: torch.linalg.svd(a_t, full_matrices=False), reps=3, warm=1)
    ms_vals = time_ms(lambda: torch.linalg.svdvals(a_t), reps=3, warm=1)
    print(f"[linalg] svd {N_SVD} x {F_SVD} split 0 (qr + the SVD of R; heat_tpu's route at world size 1 is the whole "
          f"array's SVD, torch.linalg.svd below): "
          f"||A - U S Vh||_F/||A||_F {e_rec:.3e}, S vs torch.linalg.svdvals max abs {e_s:.3e} (<= "
          f"{2 * SVD_RESID_RTOL * s_max:.3e}); cond {kappa:.2f}; first call {t_svd:.4f} s; ht.linalg.svd {ms_svd:.4f} "
          f"ms, torch.linalg.svd {ms_lib:.4f} ms, torch.linalg.svdvals {ms_vals:.4f} ms; bound: A read once "
          f"{N_SVD * F_SVD * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    del U, Vh

    # rsvd(rank 16): ||A - U S Vh||_F within sqrt(1 + k / (p - 1)) of the best rank-k error (Halko, Martinsson and
    # Tropp 2011, Thm 10.5, no power iteration; two only tighten it)
    (Ur, Sr, Vr), t_rsvd = first(lambda: ht.linalg.rsvd(A, RSVD_RANK, n_oversamples=RSVD_OVERSAMPLES, random_state=1))
    best = math.sqrt((s_lib[RSVD_RANK:].double() ** 2).sum().item())
    us = (Ur.larray * Sr.larray).double()
    e_r = math.sqrt(sum(((us[r0 : r0 + c.shape[0]] @ Vr.larray.double() - c) ** 2).sum().item() for r0, c in chunks()))
    factor = math.sqrt(1 + RSVD_RANK / (RSVD_OVERSAMPLES - 1))
    check(Ur.gshape == (N_SVD, RSVD_RANK) and e_r <= factor * best, f"rsvd error {e_r} > {factor} x {best}")
    e_rs = ((Sr.larray - s_lib[:RSVD_RANK]).abs() / s_lib[:RSVD_RANK]).max().item()
    del us, Ur, Vr
    ms_rsvd = time_ms(lambda: ht.linalg.rsvd(A, RSVD_RANK, n_oversamples=RSVD_OVERSAMPLES, random_state=1), reps=3, warm=1)
    print(f"[linalg] rsvd rank {RSVD_RANK} (+{RSVD_OVERSAMPLES}, 2 power iterations): ||A - U S Vh||_F {e_r:.6e} vs "
          f"the best rank-{RSVD_RANK} error {best:.6e} (<= x{factor:.3f}); S vs svdvals max relative {e_rs:.3e}; "
          f"first call {t_rsvd:.4f} s, warm {ms_rsvd:.4f} ms", flush=True)

    # lstsq takes heat_tpu's QR route only where min|diag R| > eps max(m, n) max|diag R|: at m = 2^22 in float32
    # eps m = 0.5, so only for cond < 2. On G (Gaussian columns, cond ~1.008) the QR route, held against the float64
    # normal equations by the first-order bound (Higham, 2nd ed., Thm 20.1), eta (2 cond + cond^2 ||r|| /
    # (||G||_2 ||x||)), with a backward error eta = sqrt(m) u: the QR's inner products run over m rows, and their
    # rounding grows like sqrt(m) u for random signs
    G = ht.array(g_t, split=0, copy=False)
    x_true = torch.randn(F_SVD, device=dev, generator=gen)
    noise = 1e-3 * torch.randn(N_SVD, device=dev, generator=gen)
    gb_t = g_t @ x_true + noise
    gb = ht.array(gb_t, split=0, copy=False)
    ht.kernels.reset_kernel_stats()
    xl, t_ls = first(lambda: ht.linalg.lstsq(G, gb))
    route = {k: v for k, v in ht.KERNEL_STATS.items() if k.startswith("qr.")}
    sg = torch.linalg.svdvals(g_t)
    kappa_g = (sg.max() / sg.min()).item()
    x64 = torch.linalg.solve(sum(c.T @ c for _, c in chunks(g_t)),
                             sum(c.T @ gb_t[r0 : r0 + c.shape[0]].double() for r0, c in chunks(g_t)))
    r_norm = math.sqrt(sum(((c @ x64 - gb_t[r0 : r0 + c.shape[0]].double()) ** 2).sum().item() for r0, c in chunks(g_t)))
    ls_bound = N_SVD**0.5 * u * (2 * kappa_g + kappa_g**2 * r_norm / (sg.max().item() * x64.norm().item()))
    e_ls = ((xl.larray.double() - x64).norm() / x64.norm()).item()
    check(xl.split is None and route == {"qr.cholqr2": 1} and e_ls <= ls_bound,
          f"lstsq (QR route {route}) vs float64: {e_ls} > {ls_bound}")
    ms_ls = time_ms(lambda: ht.linalg.lstsq(G, gb), reps=3, warm=1)
    print(f"[linalg] lstsq {N_SVD} x {F_SVD} split 0, cond {kappa_g:.4f} (QR route, {route}): vs the float64 normal "
          f"equations {e_ls:.3e} (<= {ls_bound:.3e}); first call {t_ls:.4f} s, warm {ms_ls:.4f} ms", flush=True)

    # On A (cond 100) the guard fails: lstsq is pinv(A) b with the cutoff eps max(m, n) s_1 = 0.5 s_1, the
    # truncated solution, held against its float64 value V_k S_k^-2 V_k^T A^T b (the float64 Gram's eigenpairs
    # above the cutoff). By Wedin's theorem the float32 SVD's backward error dA turns V_k by at most
    # ||dA|| / (s_k - s_k+1), which the solution feels times s_1 / s_k: bound 2 (s_1 / s_k) ||dA|| / (s_k - s_k+1),
    # ||dA|| <= SVD_RESID_RTOL ||A||_F
    b_t = a_t @ x_true + noise
    b = ht.array(b_t, split=0, copy=False)
    xp, t_lp = first(lambda: ht.linalg.lstsq(A, b))
    ev, vec = torch.linalg.eigh(sum(c.T @ c for _, c in chunks()))
    sv = ev.clamp(min=0).sqrt()
    keep = sv > torch.finfo(torch.float32).eps * max(N_SVD, F_SVD) * sv.max()
    k_ = int(keep.sum())
    vk = vec[:, keep]
    atb = sum(c.T @ b_t[r0 : r0 + c.shape[0]].double() for r0, c in chunks())
    xp64 = vk @ ((vk.T @ atb) / ev[keep])
    s_desc = sv.flip(0)
    gap = (s_desc[k_ - 1] - (s_desc[k_] if k_ < F_SVD else 0.0)).item()
    p_bound = 2 * (s_desc[0] / s_desc[k_ - 1]).item() * SVD_RESID_RTOL * a_f / gap
    e_lp = ((xp.larray.double() - xp64).norm() / xp64.norm()).item()
    check(xp.split is None and e_lp <= p_bound, f"lstsq (pinv route) vs float64 truncated: {e_lp} > {p_bound}")
    print(f"[linalg] lstsq {N_SVD} x {F_SVD} split 0, cond {kappa:.2f} (R's guard fails where cond >= 1 / (eps m): "
          f"the pinv route keeps the {k_} of {F_SVD} singular values above eps max(m, n) s_1): vs the float64 "
          f"truncated solution {e_lp:.3e} (<= {p_bound:.3e}); first call {t_lp:.4f} s", flush=True)

    # pinv of G (nothing cut): P G = I up to U's orthogonality error (<= 2e-4 by the SVD gate) amplified by cond
    P, t_pinv = first(lambda: ht.linalg.pinv(G))
    pa = sum(P.larray[:, r0 : r0 + c.shape[0]].double() @ c for r0, c in chunks(g_t))
    e_p = (pa - torch.eye(F_SVD, device=dev, dtype=torch.float64)).abs().max().item()
    check(P.gshape == (F_SVD, N_SVD) and P.split == 1 and e_p <= 2 * SVD_RESID_RTOL * kappa_g,
          f"pinv: ||pinv(G) G - I||_max {e_p} > {2 * SVD_RESID_RTOL * kappa_g}")
    del P
    ms_p = time_ms(lambda: ht.linalg.pinv(G), reps=3, warm=1)
    print(f"[linalg] pinv {N_SVD} x {F_SVD} split 0 (result split 1): ||pinv(G) G - I||_max {e_p:.3e} (<= "
          f"{2 * SVD_RESID_RTOL * kappa_g:.3e}); first call {t_pinv:.4f} s, warm {ms_p:.4f} ms", flush=True)
    del A, a_t, b, b_t, G, g_t, gb, gb_t
    torch.cuda.empty_cache()


# ---- [robust]: robust clustering of heavy-tailed data at the KMeans path's size (bench.py's k = 8, f = 32) -----
N_ROBUST, F_ROBUST, K_ROBUST = 1 << 24, 32, 8
N_OUTLIERS = 1 << 18  # 1.6 % uniform outlier rows, after 2^24 - 2^18 rows of 8 Gaussian blobs
ROBUST_SEED, KMEDOIDS_SEED, ROBUST_ITERS = 21, 22, 10
# The blob centres are ROBUST_SCALE times the rows of columns 1-7 of the 8 x 8 Hadamard matrix, tiled over the 32
# features (feature j takes column j % 7 + 1): every feature splits the blobs four against four, every pair of
# centres differs in 4 of the 7 columns, so in 16-20 features, by 2 ROBUST_SCALE. A feature is then
# N(-+ROBUST_SCALE, 1) in equal parts plus the outliers, uniform over [-ROBUST_BOX, ROBUST_BOX] (20x the centres'
# spread): its quartiles sit at ~-+ROBUST_SCALE (IQR ~2 ROBUST_SCALE), its median somewhere in the sparse gap
# between the halves, |median| < ROBUST_SCALE / 2 (the outliers' 0.8 % per side move the middle rank by
# 2^17 rows, well inside a half's 2^23). z = (x - median) / IQR then puts the centres within 0.5 + 0.25 of 0 and a
# blob point's noise at 1 / (2 ROBUST_SCALE) = 0.125 per feature. An inlier lies within 7 sigma of its centre on
# every feature (P(|N(0,1)| > 7) = 2.6e-12 per entry, 1.4e-3 expected over 2^29 entries), so |z| < 0.75 + 7 /
# (2 ROBUST_SCALE) = 1.625 for every inlier and ROBUST_CLIP = 2.5 clips outlier entries only (checked). Two centres
# lie >= 16 L1 units apart in z and a point's L1 noise is ~32 * 0.8 * 0.125 = 3.2: inliers go to their blob's
# median, accuracy > SPEC_ACC (0.999) on the inlier rows.
ROBUST_SCALE = 4.0
ROBUST_BOX = 20 * ROBUST_SCALE
ROBUST_CLIP = 2.5
ROBUST_Q = (25.0, 50.0, 75.0)
ROBUST_COLS = (0, 9, 18, 31)  # full-length columns held against numpy on the host
N_ROBUST_SLICE = 1 << 16      # rows at which every column's percentiles are held against numpy
N_TOPK, N_HIST_BINS = 1000, 64


def robust_centres(dev):
    """[robust]'s K_ROBUST x F_ROBUST blob centres (see ROBUST_SCALE)."""
    import torch

    h = torch.ones(1, 1)
    while h.shape[0] < K_ROBUST:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)  # Sylvester's construction
    return (h[:, torch.arange(F_ROBUST) % (K_ROBUST - 1) + 1] * ROBUST_SCALE).to(dev)


def robust_data(ht, world=1):
    """[robust]'s data, the same global arrays at any world size (split draws are split-invariant): the blob of
    each inlier row (``randint``), its centre + ``randn``, then the outlier rows (``rand`` over the box), joined
    by ``concatenate``; split 0. Returns (member, x)."""
    n_out = N_OUTLIERS * world
    n_in = N_ROBUST * world - n_out
    ht.random.seed(ROBUST_SEED)
    member = ht.random.randint(0, K_ROBUST, size=(n_in,), split=0, dtype=ht.int64)
    centres = robust_centres(member.larray.device)
    blobs = ht.random.randn(n_in, F_ROBUST, split=0) + ht.DNDarray(centres[member.larray], gshape=(n_in, F_ROBUST),
                                                                   split=0)
    out = ht.random.rand(n_out, F_ROBUST, split=0) * (2 * ROBUST_BOX) - ROBUST_BOX
    return member, ht.concatenate([blobs, out], axis=0)


def first_rows(member, k):
    """The global index of the first row of each of the k blobs (an allreduce of MIN across ranks)."""
    import torch

    comm = member.comm
    off = comm.chunk(member.gshape, 0)[0]
    m = member.larray
    big = torch.iinfo(torch.int64).max
    hit = m.unsqueeze(1) == torch.arange(k, device=m.device).unsqueeze(0)
    pos = torch.where(hit, torch.arange(m.numel(), device=m.device).unsqueeze(1) + off, torch.full_like(hit, big,
                                                                                                       dtype=torch.int64))
    first = pos.amin(dim=0) if m.numel() else torch.full((k,), big, dtype=torch.int64, device=m.device)
    return comm.allreduce(first, "min").tolist()


def robust_path(ht, fills=None):
    """[robust]'s path through its user-facing calls: draws and concatenate; percentiles and median along axis 0;
    robust scaling; the outlier clip by mask assignment; average, skew, kurtosis, cov, a histogram; KMedians from
    one row of each blob; KMedoids from a random init; unique/bincount of the labels; topk of the largest L1
    distances to the assigned centre; reshape to one flat axis, sort, and back. Returns the results and each
    step's host seconds (work ending in a synchronize). ``fills``, where given, receives the arguments of every
    threefry draw the path makes."""
    import torch

    from heat_tpu_torch.core import random as ht_random

    t, r = {}, {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out

    real_fill = ht_random._fill
    if fills is not None:
        def recording_fill(*args):
            fills.append(args)
            return real_fill(*args)

        ht_random._fill = recording_fill
    try:
        r["member"], x = step("draws + concatenate", lambda: robust_data(ht, ht.get_comm().size))
        r["pct"] = step("percentile", lambda: ht.percentile(x, list(ROBUST_Q), axis=0))
        r["med"] = step("median", lambda: ht.median(x, axis=0))
        z = step("robust scaling", lambda: (x - r["med"]) / (r["pct"][2] - r["pct"][0]))

        def clip():
            mask = ht.abs(z) > ROBUST_CLIP
            z[mask] = ROBUST_CLIP
            return mask

        r["clipped"] = step("clip (mask assignment)", clip)
        r["avg"] = step("average", lambda: ht.average(z, axis=0))
        r["skew"] = step("skew", lambda: ht.skew(z, axis=0))
        r["kurt"] = step("kurtosis", lambda: ht.kurtosis(z, axis=0))
        r["cov"] = step("cov", lambda: ht.cov(z, rowvar=False))
        r["hist"] = step("histogram", lambda: ht.histogram(z[:, 0], bins=N_HIST_BINS))
        rows = first_rows(r["member"], K_ROBUST)
        r["init"] = z[rows]
        r["km"] = step("KMedians fit", lambda: ht.cluster.KMedians(K_ROBUST, init=r["init"], max_iter=ROBUST_ITERS,
                                                                   tol=None).fit(z))
        r["kd"] = step("KMedoids fit", lambda: ht.cluster.KMedoids(K_ROBUST, init="random", random_state=KMEDOIDS_SEED,
                                                                   max_iter=ROBUST_ITERS).fit(z))
        labels = r["km"].labels_
        r["unique"], r["counts"] = step("unique + bincount", lambda: (ht.unique(labels), ht.bincount(labels)))

        def farthest():
            assigned = ht.DNDarray(r["km"].cluster_centers_.larray[labels.larray], gshape=z.gshape, split=0)
            d = ht.sum(ht.abs(z - assigned), axis=1)
            return d, ht.topk(d, N_TOPK)

        r["d"], r["topk"] = step("topk", farthest)

        def movement():
            flat = ht.reshape(z, (z.size,))
            s, i = ht.sort(flat)
            return flat, s, i, ht.reshape(s, z.gshape)

        r["flat"], r["sorted"], r["order"], r["back"] = step("reshape + sort + reshape", movement)
    finally:
        ht_random._fill = real_fill
    r["x"], r["z"] = x, z
    return r, t


def robust_numpy_percentile(col, q, n):
    """heat_tpu's ``_sorted_percentile`` of one float32 column on the host: numpy's index arithmetic, the order
    statistics from ``np.partition``, and ``vlo + w (vhi - vlo)`` in float32 (numpy's own lerp rounds
    ``vhi - (vhi - vlo)(1 - w)`` where w >= 0.5, one rounding apart)."""
    import numpy as np

    pos = (np.asarray(q, dtype=np.float64) / 100.0).astype(np.float32) * np.float32(n - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    hi = np.clip(np.ceil(pos).astype(np.int64), 0, n - 1)
    part = np.partition(col, np.unique(np.concatenate([lo, hi])))
    vlo, vhi = part[lo], part[hi]
    w = (pos - np.floor(pos)).astype(np.float32)
    return (vlo + w * (vhi - vlo)).astype(np.float32)


def robust_phase(dev):
    """[robust]: robust clustering of heavy-tailed data at 2^24 x 32 on one card through its user-facing calls;
    its two kernels on the path's own inputs against their plain versions; order statistics against numpy; the
    KMedians centres against numpy's medians of the final members; the KMedoids medoids against the members'
    L1-nearest rows to their medians; the same path through the plain versions; per-step times."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import (
        MOMENTS_KERNEL, THREEFRY_KERNEL, chunk_moments, forced_mode, moments_local, threefry_bits, threefry_plain,
    )

    ht.use_device("gpu")
    fills = []
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t_wall = time.perf_counter()
    r, t = robust_path(ht, fills)
    t_wall = time.perf_counter() - t_wall
    launches, stats = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS)
    print(f"[robust] launches {launches} KERNEL_STATS {stats}", flush=True)
    check(launches["threefry_bits"] > 0 and launches["moments_onepass"] > 0,
          f"the path should launch threefry_bits (its draws, KMedoids' init) and moments_onepass (average): {launches}")
    check(not any(k.endswith(".torch") for k in stats), f"a plain version ran on the path: {stats}")
    x, z, km, kd = r["x"], r["z"], r["km"], r["kd"]
    n_in = N_ROBUST - N_OUTLIERS
    member = r["member"].larray

    # ---- the two kernels on the path's own inputs
    za = z.larray
    cnt, mean, m2 = moments_local(za, N_ROBUST)
    cnt0, mean0, m20 = chunk_moments(za, N_ROBUST)
    e_mean, e_m2 = (mean - mean0).abs(), (m2 - m20).abs()
    check(float(cnt) == float(cnt0) == float(N_ROBUST), "[robust] moments counts")
    check(bool((e_mean <= MEAN_ATOL + MEAN_RTOL * mean0.abs()).all()), f"[robust] moments mean: {e_mean.max().item()}")
    check(bool((e_m2 <= M2_RTOL * m20.abs() + 1e-6).all()), f"[robust] moments M2: {e_m2.max().item()}")
    check(torch.equal(r["avg"].larray, mean), "[robust] average(z, axis=0) is not the moments kernel's mean")
    kinds = []
    for args in fills:
        got, want = threefry_bits(*args), threefry_plain(*args)
        check(torch.equal(got, want), f"[robust] threefry_bits' {args[2]} draw differs from its plain version")
        kinds.append(f"{args[2]} x {got.numel()}")
        del got, want
    normal = next(a for a in fills if a[2] == "normal32")
    drawn = threefry_bits(*normal).reshape(n_in, F_ROBUST)
    check(torch.equal(drawn + robust_centres(dev)[member], x.larray[:n_in]),
          f"[robust] the path's blobs are not its draw: {(drawn + robust_centres(dev)[member] - x.larray[:n_in]).abs().max()}")
    del drawn
    print(f"[robust] moments_onepass on the path's z {tuple(za.shape)}: count exact, mean max abs "
          f"{e_mean.max().item():.3e}, M2 max rel {(e_m2 / m20.abs()).max().item():.3e} (<= {M2_RTOL}), average == the "
          f"kernel's mean; threefry_bits: the path's {len(fills)} draws ({', '.join(kinds)}) bit-identical to the "
          f"plain version, and the blobs are the normal draw plus the centres, bit for bit", flush=True)

    # ---- order statistics against numpy (host)
    xh = x.larray[:, list(ROBUST_COLS)].cpu().numpy()
    pct, med = r["pct"].larray.cpu().numpy(), r["med"].larray.cpu().numpy()
    worst_np = 0.0
    for j, c in enumerate(ROBUST_COLS):
        want = robust_numpy_percentile(xh[:, j], ROBUST_Q, N_ROBUST)
        check(np.array_equal(pct[:, c], want), f"[robust] percentiles of column {c}: {pct[:, c]} vs {want}")
        check(med[c] == np.median(xh[:, j]), f"[robust] median of column {c}: {med[c]} vs {np.median(xh[:, j])}")
        ref = np.percentile(xh[:, j], ROBUST_Q).astype(np.float32)
        worst_np = max(worst_np, float(np.max(np.abs(pct[:, c] - ref) / np.spacing(np.abs(ref)))))
    small = x[:N_ROBUST_SLICE]
    ps, ms = ht.percentile(small, list(ROBUST_Q), axis=0).larray.cpu().numpy(), ht.median(small, axis=0).larray.cpu().numpy()
    sh = small.larray.cpu().numpy()
    for c in range(F_ROBUST):
        check(np.array_equal(ps[:, c], robust_numpy_percentile(sh[:, c], ROBUST_Q, N_ROBUST_SLICE)),
              f"[robust] percentiles of column {c} at {N_ROBUST_SLICE} rows")
        check(ms[c] == np.median(sh[:, c]), f"[robust] median of column {c} at {N_ROBUST_SLICE} rows")
    del xh, sh, small

    # ---- the clip touched outlier rows only, and only entries beyond the clip
    clipped = r["clipped"].larray
    check(not bool(clipped[:n_in].any()), "[robust] the clip touched an inlier row")
    check(bool((za[clipped] == ROBUST_CLIP).all()) and bool((za.abs() <= ROBUST_CLIP).all()), "[robust] clip values")

    # ---- KMedians: centres are numpy's medians of the final members; inlier accuracy
    labels = km.labels_.larray
    acc, perm = matched_labels(labels[:n_in], member, K_ROBUST, what="[robust] KMedians labels vs the blobs")
    check(acc > SPEC_ACC, f"[robust] KMedians labels agree with the blobs on {acc} of the inlier rows")
    lab_h, centres_h = labels.cpu().numpy(), km.cluster_centers_.larray.cpu().numpy()
    for c in range(K_ROBUST):
        rows = np.nonzero(lab_h == c)[0]
        check(rows.size > 0, f"[robust] KMedians cluster {c} is empty")
        want = np.median(za[torch.as_tensor(rows, device=dev)].cpu().numpy(), axis=0)
        check(np.array_equal(centres_h[c], want), f"[robust] KMedians centre {c} is not numpy's median of its members")

    # ---- KMedoids: each medoid is a row of z, the L1-nearest member to its cluster's median
    from heat_tpu_torch.cluster.kmedians import _l1_distances

    lab_d = kd.labels_.larray
    lab_dh = lab_d.cpu().numpy()
    has = [bool((lab_dh == c).any()) for c in range(K_ROBUST)]
    med_all = torch.stack([torch.as_tensor(np.median(za[torch.as_tensor(np.nonzero(lab_dh == c)[0], device=dev)].cpu()
                                                     .numpy(), axis=0), device=dev) if has[c] else
                           kd.cluster_centers_.larray[c] for c in range(K_ROBUST)])
    d_med = _l1_distances(za, med_all)  # the distances medoid_step takes, on the same shapes
    d_med = torch.where(lab_d.unsqueeze(1) == torch.arange(K_ROBUST, device=dev), d_med, float("inf"))
    near = torch.argmin(d_med, dim=0)
    for c in range(K_ROBUST):
        if has[c]:
            check(torch.equal(kd.cluster_centers_.larray[c], za[near[c]]),
                  f"[robust] KMedoids centre {c} is not its members' L1-nearest row to their median")
    del d_med

    # ---- unique, bincount, topk, and the data movement
    check(torch.equal(r["unique"].larray, torch.arange(K_ROBUST, device=dev)), "[robust] unique labels")
    check(torch.equal(r["counts"].larray, torch.bincount(labels, minlength=K_ROBUST)), "[robust] bincount")
    tv, ti = r["topk"]
    ref_v = torch.topk(r["d"].larray, N_TOPK).values
    check(torch.equal(tv.larray, ref_v) and torch.equal(r["d"].larray[ti.larray], tv.larray), "[robust] topk")
    check(bool((ti.larray >= n_in).float().mean() > 0.99), "[robust] the farthest rows should be outliers")
    s, order, flat = r["sorted"].larray, r["order"].larray, r["flat"].larray
    check(r["back"].gshape == z.gshape and torch.equal(r["back"].larray.reshape(-1), s), "[robust] reshape back")
    check(torch.equal(flat, za.reshape(-1)) and torch.equal(flat[order], s), "[robust] sort's indices")
    check(bool((s[1:] >= s[:-1]).all()), "[robust] sorted values are not ascending")
    ties = s[1:] == s[:-1]
    check(bool((order[1:][ties] > order[:-1][ties]).all()), "[robust] sort is not stable")
    check(torch.equal(torch.sort(order).values, torch.arange(order.numel(), device=dev)), "[robust] not a permutation")
    n_clip = int(clipped.sum())
    moments_line = (f"average {r['avg'].larray[:2].tolist()}, skew {r['skew'].larray[:2].tolist()}, kurtosis "
                    f"{r['kurt'].larray[:2].tolist()} (features 0-1), cov[0, :2] {r['cov'].larray[0, :2].tolist()}, "
                    f"histogram of feature 0: {int(r['hist'][0].larray.sum())} counts in {N_HIST_BINS} bins")
    km_iter, kd_iter = km.n_iter_, kd.n_iter_
    lab_km, lab_kd = labels.clone(), lab_d.clone()
    pct_t, med_t = r["pct"].larray.clone(), r["med"].larray.clone()
    del r, x, z, za, clipped, s, order, flat, tv, ti, ref_v, km, kd, labels, lab_d
    torch.cuda.empty_cache()

    # ---- the same path through the plain versions: identical labels
    with forced_mode(THREEFRY_KERNEL, "torch"), forced_mode(MOMENTS_KERNEL, "torch"):
        r0, t0 = robust_path(ht)
    check(torch.equal(r0["pct"].larray, pct_t) and torch.equal(r0["med"].larray, med_t), "[robust] plain path order stats")
    check(torch.equal(r0["km"].labels_.larray, lab_km), "[robust] KMedians labels differ on the plain path")
    check(torch.equal(r0["kd"].labels_.larray, lab_kd), "[robust] KMedoids labels differ on the plain path")
    del r0
    torch.cuda.empty_cache()
    print(f"[robust] n={N_ROBUST} ({N_OUTLIERS} uniform outlier rows over +-{ROBUST_BOX}) f={F_ROBUST} k={K_ROBUST}: "
          f"percentiles {ROBUST_Q} and medians equal numpy's order statistics and heat_tpu's lerp on columns "
          f"{ROBUST_COLS} at full length and every column at {N_ROBUST_SLICE} rows (np.percentile's own lerp within "
          f"{worst_np:.1f} ulp); the clip set {n_clip} outlier entries to {ROBUST_CLIP}, no inlier; {moments_line}; "
          f"KMedians ({km_iter} iterations) agrees with the blobs on {acc:.6f} of the inlier rows and its centres "
          f"are numpy's medians of the final members bit for bit; KMedoids ({kd_iter} iterations) medoids are their "
          f"members' L1-nearest rows to the medians; unique/bincount, topk ({N_TOPK}) and the stable sort of the "
          f"{N_ROBUST * F_ROBUST} flat values checked; the plain path gives the same order statistics and labels",
          flush=True)
    print("[robust] per step (host clock, first calls): " + ", ".join(f"{k} {v:.4f} s" for k, v in t.items())
          + f"; whole path {t_wall:.4f} s wall; plain path steps: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in t0.items()), flush=True)
    return {k: launches.get(k, 0) for k in ("moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused",
                                             "threefry_bits")}


# ---- [dtypes]: the small, half and complex types at [robust]'s width on one card, data from --seed with numpy -----
N_DT, F_DT, K_DT = 1 << 24, 32, 8  # uint8 pixel rows: 512 MiB (2 GiB as float32)
DT_LO, DT_HI, DT_SIGMA = 40.0, 215.0, 12.0  # blob centres uniform in [DT_LO, DT_HI] per feature, noise sigma, in
# pixel units; values rounded and clipped to [0, 255]. Two centres differ by ~sqrt(32 * 175^2 / 6) = 400 against a
# noise radius of ~sqrt(32) * 12 = 68, so a fit from one row of each blob labels well above DT_ACC
DT_ACC = 0.999
N_CX, CX_ROWS, CX_FREQ, CX_NOISE = 1 << 24, 1 << 20, 1234.5, 0.1  # complex signal; complex (CX_ROWS, F_DT) matrix
N_CONV, M_CONV, CONV_CUTOFF = 1 << 26, 1023, 0.125  # signal samples; windowed-sinc taps (Blackman), cutoff/rate
N_PAD, PAD_WIDTH = 1 << 12, ((3, 5), (2, 4))  # pad's six new modes on a split (N_PAD, N_PAD) float32 array
PAD_MODES = ("linear_ramp", "maximum", "mean", "median", "minimum", "empty")
# Sums in float32 of n terms, in whatever order the card's reduction takes: by Higham and Mary's probabilistic
# bound (SIAM J. Sci. Comput. 41(5), 2019, thm. 3.1), |error| <= lambda sqrt(n) u sum|x_i| holds for any order with
# probability >= 1 - 2n exp(-lambda^2 (1 - u)^2 / 2); lambda = 8 at n = 2^24 leaves 2^25 e^-32 = 4e-7. A result
# rounded to bfloat16 (float16) adds one rounding, u = 2^-8 (2^-11) of its value.
SUM_LAMBDA = 8.0
BF16_U, F16_U = 2.0 ** -8, 2.0 ** -11


def normal32(seed, shape, threads=8, finish=None, out=None):
    """float32 standard normal draws of ``shape`` from ``seed`` with numpy, in ``threads`` slabs of rows drawn in
    parallel by independent child generators (numpy releases the GIL while it fills an array and in its ufuncs).
    ``finish(lo, hi, slab)``, where given, turns each slab into rows ``[lo, hi)`` of ``out`` in its thread."""
    import concurrent.futures

    import numpy as np

    if out is None:
        out = np.empty(shape, np.float32)
    rows = -(-shape[0] // threads)
    kids = np.random.SeedSequence(seed).spawn(threads)

    def fill(i):
        lo, hi = i * rows, min((i + 1) * rows, shape[0])
        if hi > lo:
            slab = np.random.default_rng(kids[i]).standard_normal((hi - lo,) + tuple(shape[1:]), dtype=np.float32)
            if finish is None:
                out[lo:hi] = slab
            else:
                finish(lo, hi, slab)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        list(pool.map(fill, range(threads)))
    return out


def windowed_sinc(m, cutoff):
    """``m`` float32 taps of a Blackman-windowed sinc low-pass filter at ``cutoff`` (a share of the sample rate),
    summing to 1."""
    import numpy as np

    k = np.arange(m) - (m - 1) / 2
    h = np.sinc(2 * cutoff * k) * np.blackman(m)
    return (h / h.sum()).astype(np.float32)


def accumulation_bound(n, abs_sum):
    """SUM_LAMBDA's bound on a float32 sum of ``n`` terms whose magnitudes add to ``abs_sum``."""
    return SUM_LAMBDA * math.sqrt(n) * F32_UNIT_ROUNDOFF * abs_sum


def moments_vs_plain(tag, xa):
    """``moments_onepass`` on the (n, f) tensor ``xa`` against its plain version, within phase 3's MEAN/M2
    tolerances; returns the line to print."""
    import torch

    from heat_tpu_torch.core.kernels import chunk_moments, moments_local

    n = xa.shape[0]
    cnt, mean, m2 = moments_local(xa, n)
    cnt0, mean0, m20 = chunk_moments(xa, n)
    e_mean, e_m2 = (mean - mean0).abs(), (m2 - m20).abs()
    # the count is a float32 in both: n itself up to 2^24, n rounded to float32 past it
    check(float(cnt) == float(cnt0) == float(torch.tensor(n, dtype=torch.float32)), f"{tag} moments counts")
    check(bool((e_mean <= MEAN_ATOL + MEAN_RTOL * mean0.abs()).all()), f"{tag} moments mean: {e_mean.max().item()}")
    check(bool((e_m2 <= M2_RTOL * m20.abs() + 1e-6).all()), f"{tag} moments M2: {e_m2.max().item()}")
    return (f"moments_onepass on {tuple(xa.shape)}: count exact (in float32), mean max abs {e_mean.max().item():.3e}, M2 max rel "
            f"{(e_m2 / m20.abs()).max().item():.3e} (<= {M2_RTOL})")


def lloyd_vs_plain(tag, data, cen, n, expansion=False):
    """``lloyd_fused`` on ``data`` from the centres ``cen`` against its plain version; returns (labels, inertia,
    the line to print). Labels may differ only at near-ties, and a row labelled otherwise moves its counts and
    values between two clusters. Per cluster c, both versions add the n_c <= n rows' float32 values in their own
    order: each sum is within SUM_LAMBDA's bound, lambda sqrt(n) u sum|x|, of the exact one, so the two are within twice
    that of each other (the rows that moved added to the bound); the inertia, a sum of n positive terms, likewise.
    With ``expansion``, the inertia's bound also holds each row's d2 = (|x|^2 + |c|^2) - 2 x.c, evaluated in its own
    order by each version, within gamma_{f+2} (|x| + |c|)^2 of the exact one (f + 2 roundings in a chain, as the kNN
    bound above): the cancellation that dominates where few rows lie near their centre (n = 1).
    Phase 3's SUMS_RTOL of the largest |sum| assumes columns of either sign: a cluster of pixel rows sums values of
    one sign, where sum|x| = |sum x|."""
    import torch

    from heat_tpu_torch.core.kernels import assign_stats, lloyd_local
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    sums, counts, labels, inertia = lloyd_local(data, cen, n)
    sums0, counts0, labels0, inertia0 = assign_stats(data, cen, n)
    k = cen.shape[0]
    two = torch.topk(_quadratic_expand(data, cen), 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
    diff = labels != labels0
    check(not bool((diff & ~near).any()), f"{tag} lloyd labels differ outside near-ties")
    moved = torch.zeros(k, dtype=torch.float64, device=data.device)
    moved.index_add_(0, labels[diff].long(), torch.ones(int(diff.sum()), dtype=torch.float64, device=data.device))
    moved.index_add_(0, labels0[diff].long(), torch.ones(int(diff.sum()), dtype=torch.float64, device=data.device))
    check(bool(((counts.double() - counts0.double()).abs() <= moved).all()), f"{tag} lloyd counts")
    onehot = torch.nn.functional.one_hot(labels0.long(), k).to(data.dtype)
    abs_sums = (onehot.T @ data.abs()).double()
    moved_abs = torch.zeros_like(abs_sums)
    if bool(diff.any()):
        rows = data[diff].abs().double()
        moved_abs.index_add_(0, labels[diff].long(), rows)
        moved_abs.index_add_(0, labels0[diff].long(), rows)
    bound = 2 * SUM_LAMBDA * math.sqrt(n) * F32_UNIT_ROUNDOFF * abs_sums + moved_abs
    e = (sums.double() - sums0.double()).abs()
    check(bool((e <= bound).all()), f"{tag} lloyd sums: worst {(e / bound).max().item():.3f} of the bound")
    e_in = abs(float(inertia) - float(inertia0))
    in_bound = 2 * SUM_LAMBDA * math.sqrt(n) * F32_UNIT_ROUNDOFF * abs(float(inertia0)) + two[diff].sum().item()
    if expansion:
        norms = data[:n].double().norm(dim=1) + cen.double().norm(dim=1)[labels0[:n].long()]
        in_bound += 2 * _gamma(data.shape[1] + 2) * float((norms * norms).sum())
    check(e_in <= in_bound, f"{tag} lloyd inertia: {e_in} > {in_bound}")
    line = (f"lloyd_fused on {tuple(data.shape)}: labels differ on {int(diff.sum())} rows ({int(near.sum())} near-tie "
            f"rows), sums worst {(e / bound).max().item():.3f} of the bound (max abs {e.max().item():.3e}, max |sum| "
            f"{sums0.abs().max().item():.3e}), inertia rel {e_in / max(abs(float(inertia0)), 1e-30):.3e} "
            f"({e_in / in_bound:.3f} of its bound)")
    return labels, inertia, line


def dtypes_phase(dev, seed, smi):
    """[dtypes]: the types beyond float32 through their user-facing calls on one card. uint8 pixel blobs are cast,
    standardized (``moments_onepass``) and clustered (``lloyd_fused``), summed exactly; the standardized data in
    bfloat16 and float16 is reduced and multiplied; a complex64 signal goes through ``complex_math``, ``vdot``, a
    complex product and the lexicographic order; a 2^26-sample signal is convolved in the three modes (and once
    with cuDNN's TF32 switched on around the call); ``pad`` runs its six new modes on a split array. Both kernels
    are held against their plain versions on the path's own tensors; every result against float64 (complex128)
    within the bounds stated above. Returns the kernels' launch counts of the pixel path."""
    import concurrent.futures

    import numpy as np
    import scipy.fft
    import scipy.signal
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import chunk_moments, moments_local

    ht.use_device("gpu")
    rng = np.random.default_rng(seed)
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        steps[name] = (time.perf_counter() - t0, a.elapsed_time(b))
        return out

    # ---- uint8 pixels: cast, standardize, cluster; counts zeroed just before the path and read just after
    sections = {}
    t_host = time.perf_counter()
    # the convolution's signal first: scipy's float64 reference runs on host threads while the card works
    a_h = normal32(seed + 4, (N_CONV,))
    taps = windowed_sinc(M_CONV, CONV_CUTOFF)

    def reference():
        t0 = time.perf_counter()
        with scipy.fft.set_workers(8):
            ref = scipy.signal.fftconvolve(a_h.astype(np.float64), taps.astype(np.float64))
        return ref, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(reference)
    member_h = rng.integers(0, K_DT, N_DT)
    centres_h = rng.uniform(DT_LO, DT_HI, (K_DT, F_DT)).astype(np.float32)
    x_h = np.empty((N_DT, F_DT), np.uint8)

    def pixels(lo, hi, slab):
        slab *= np.float32(DT_SIGMA)
        slab += centres_h[member_h[lo:hi]]
        x_h[lo:hi] = np.clip(np.rint(slab, out=slab), 0, 255, out=slab)

    normal32(seed + 1, (N_DT, F_DT), finish=pixels, out=x_h)
    t_host = time.perf_counter() - t_host
    last = [time.perf_counter()]

    def mark(name):  # host seconds of each section, checks included
        now = time.perf_counter()
        sections[name] = now - last[0]
        last[0] = now
    rows = [int(np.argmax(member_h == c)) for c in range(K_DT)]  # the first row of each blob: the fit's init
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t_wall = time.perf_counter()
    x = step("array(uint8, split=0)", lambda: ht.array(x_h, split=0))
    xc = step("astype(float32)", lambda: x.astype(ht.float32))
    xf = step("/ 255", lambda: xc / 255)
    del xc
    mu, sd = step("mean + std", lambda: (ht.mean(xf, axis=0), ht.std(xf, axis=0)))
    z = step("standardize", lambda: (xf - mu) / sd)
    init = z[rows]
    km = step("KMeans fit", lambda: ht.cluster.KMeans(K_DT, init=init, max_iter=ITERS, tol=None).fit(z))
    s8 = step("sum(uint8, axis=0)", lambda: ht.sum(x, axis=0))
    m8 = step("max(uint8)", lambda: ht.max(x))
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t_wall
    launches, stats = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS)
    print(f"[dtypes] launches {launches} KERNEL_STATS {stats}", flush=True)
    check(launches["moments_onepass"] == 1 and launches["lloyd_fused"] == ITERS + 1,
          f"[dtypes] the pixel path should launch moments_onepass once (mean and std) and lloyd_fused {ITERS + 1} "
          f"times: {launches}")
    check(not any(k.endswith(".torch") for k in stats), f"[dtypes] a plain version ran on the path: {stats}")
    check(x.dtype is ht.uint8 and xf.dtype is ht.float32 and s8.dtype is ht.int64 and m8.dtype is ht.uint8,
          f"[dtypes] types {x.dtype}, {xf.dtype}, {s8.dtype}, {m8.dtype}")
    check(np.array_equal(s8.larray.cpu().numpy(), x_h.sum(axis=0, dtype=np.int64)), "[dtypes] uint8 sum vs numpy")
    check(m8.item() == int(x_h.max()), f"[dtypes] uint8 max {m8.item()} vs {x_h.max()}")
    acc, _ = matched_labels(km.labels_.larray, torch.as_tensor(member_h, device=dev), K_DT,
                            what="[dtypes] KMeans labels vs the blobs")
    check(acc > DT_ACC, f"[dtypes] KMeans labels agree with the blobs on {acc} of the rows")
    # the two kernels on the path's own tensors
    xa = xf.larray
    cnt, mean, m2 = moments_local(xa, N_DT)
    cnt0, mean0, m20 = chunk_moments(xa, N_DT)
    e_mean, e_m2 = (mean - mean0).abs(), (m2 - m20).abs()
    check(float(cnt) == float(cnt0) == float(N_DT), "[dtypes] moments counts")
    check(bool((e_mean <= MEAN_ATOL + MEAN_RTOL * mean0.abs()).all()), f"[dtypes] moments mean: {e_mean.max().item()}")
    check(bool((e_m2 <= M2_RTOL * m20.abs() + 1e-6).all()), f"[dtypes] moments M2: {e_m2.max().item()}")
    check(torch.equal(mu.larray, mean), "[dtypes] mean(x, axis=0) is not the moments kernel's mean")
    _, _, l_init = lloyd_vs_plain("[dtypes] (init)", z.larray, init.larray, N_DT)
    _, inertia, l_fit = lloyd_vs_plain("[dtypes] (fitted)", z.larray, km.cluster_centers_.larray, N_DT)
    check(float(inertia) == km.inertia_, "[dtypes] the last Lloyd launch's inertia is not inertia_")
    warm = {
        "astype(float32)": time_ms(lambda: x.astype(ht.float32), reps=5, warm=1),
        "KMeans fit": time_ms(lambda: ht.cluster.KMeans(K_DT, init=init, max_iter=ITERS, tol=None).fit(z), reps=3,
                              warm=1),
        "sum(uint8, axis=0)": time_ms(lambda: ht.sum(x, axis=0), reps=5, warm=1),
        "max(uint8)": time_ms(lambda: ht.max(x), reps=5, warm=1),
    }
    print(f"[dtypes] moments_onepass on the path's x/255 {tuple(xa.shape)}: count exact, mean max abs "
          f"{e_mean.max().item():.3e}, M2 max rel {(e_m2 / m20.abs()).max().item():.3e} (<= {M2_RTOL}), mean == the "
          f"kernel's mean; from the init centres {l_init}; from the fitted centres {l_fit}", flush=True)
    print(f"[dtypes] pixels {N_DT} x {F_DT} uint8 ({K_DT} blobs, sigma {DT_SIGMA}): KMeans agrees with the blobs on "
          f"{acc:.6f} of the rows; sum(axis=0) int64 equals numpy's, max {m8.item()}; the cast moves "
          f"{N_DT * F_DT * 5} B, bound {N_DT * F_DT * 5 / HBM_BYTES_PER_S * 1e3:.4f} ms; path {t_wall:.4f} s wall "
          f"(the host's numpy draw before it {t_host:.2f} s)", flush=True)
    del x, xf, xa, km, init, mu, sd
    torch.cuda.empty_cache()

    mark("pixels")
    # ---- half precision: the standardized z in bfloat16 and float16, against float64 of the rounded values
    half_lines = []
    # float16 tops out at 65504 and the Gram's diagonal of z is ~2^24: its data is z * 2^-6 (an exact scaling),
    # whose Gram entries stay near 2^12
    for name, hdt, u_out, src in (("bfloat16", ht.bfloat16, BF16_U, z), ("float16", ht.float16, F16_U, z * 2.0 ** -6)):
        zz = step(f"astype({name})", lambda: src.astype(hdt))
        s = step(f"sum({name}, axis=0)", lambda: ht.sum(zz, axis=0))
        mn = step(f"mean({name}, axis=0)", lambda: ht.mean(zz, axis=0))
        vr = step(f"var({name}, axis=0)", lambda: ht.var(zz, axis=0))
        g = step(f"matmul({name} z.T, z)", lambda: ht.matmul(zz.T, zz))
        check(all(r.dtype is hdt for r in (zz, s, mn, vr, g)), f"[dtypes] {name} results change type")
        warm[f"sum({name}, axis=0)"] = time_ms(lambda: ht.sum(zz, axis=0), reps=5, warm=1)
        warm[f"var({name}, axis=0)"] = time_ms(lambda: ht.var(zz, axis=0), reps=5, warm=1)
        warm[f"matmul({name} z.T, z)"] = time_ms(lambda: ht.matmul(zz.T, zz), reps=5, warm=1)
        z64 = zz.larray.double()
        n = z64.shape[0]
        abs_sum = z64.abs().sum(dim=0)
        s_ref = z64.sum(dim=0)
        m_ref = s_ref / n
        d = z64 - m_ref
        v_ref = (d * d).sum(dim=0) / n
        g_ref, g_abs = z64.T @ z64, z64.abs().T @ z64.abs()
        del d
        errs = {}
        for what, r, ref, bound in (
            ("sum", s, s_ref, u_out * s_ref.abs() + accumulation_bound(n, abs_sum)),
            ("mean", mn, m_ref, u_out * m_ref.abs() + accumulation_bound(n, abs_sum) / n
             + F32_UNIT_ROUNDOFF * m_ref.abs()),
            # two passes in float32: each (x - m)^2 carries three roundings, the sum the accumulation bound
            ("var", vr, v_ref, u_out * v_ref + (SUM_LAMBDA * math.sqrt(n) + 4) * F32_UNIT_ROUNDOFF * v_ref),
            # products of two half values are exact in float32
            ("matmul", g, g_ref, u_out * g_ref.abs() + accumulation_bound(n, g_abs)),
        ):
            e = (r.larray.double() - ref).abs()
            check(bool((e <= bound).all()), f"[dtypes] {name} {what}: worst {(e / bound).max().item():.3f} of the bound")
            errs[what] = (e / bound).max().item()
        half_lines.append(f"{name}: " + ", ".join(f"{k} {v:.3f}" for k, v in errs.items()))
        del zz, z64, s, mn, vr, g, src
        torch.cuda.empty_cache()
    print(f"[dtypes] half precision on the standardized {tuple(z.gshape)} (float16: z * 2^-6): every result keeps its "
          f"type; worst error "
          f"as a share of its bound (u_out |ref| + float32 accumulation): " + "; ".join(half_lines), flush=True)
    del z
    torch.cuda.empty_cache()

    mark("half")
    # ---- complex64: a tone plus complex noise, built with ht operations
    ph_h = (2 * np.pi * ((CX_FREQ * np.arange(N_CX, dtype=np.float64) / N_CX) % 1.0)).astype(np.float32)
    noise_h = normal32(seed + 2, (2, N_CX)) * np.float32(CX_NOISE)
    ph, nr, ni = (ht.array(a, split=0) for a in (ph_h, noise_h[0], noise_h[1]))
    s = step("complex signal", lambda: ht.exp(ph * 1j) + (nr + ni * 1j))
    check(s.dtype is ht.complex64 and s.split == 0, f"[dtypes] the signal is {s.dtype}, split {s.split}")
    mag = step("abs", lambda: ht.abs(s))
    ang = step("angle", lambda: ht.angle(s))
    cj = step("conj", lambda: ht.conj(s))
    re, im = step("real + imag", lambda: (ht.real(s), ht.imag(s)))
    vd = step("vdot(s, s)", lambda: ht.vdot(s, s))
    mx = step("max (lexicographic)", lambda: ht.max(s))
    s_rev = ht.flip(s, 0)
    lt = step("s < flip(s)", lambda: s < s_rev)
    for name, fn in (("abs", lambda: ht.abs(s)), ("angle", lambda: ht.angle(s)), ("vdot(s, s)", lambda: ht.vdot(s, s)),
                     ("max (lexicographic)", lambda: ht.max(s))):
        warm[name] = time_ms(fn, reps=5, warm=1)
    # the references in complex128 and float64 on the card (the elementwise ones are correctly rounded there to
    # far below float32's ulp)
    sl = s.larray
    s128 = sl.to(torch.complex128)
    check(mag.dtype is ht.float32 and ang.dtype is ht.float32 and vd.dtype is ht.complex64, "[dtypes] complex types")
    e_mag = (mag.larray.double() - s128.abs()).abs()
    check(bool((e_mag <= 4 * F32_UNIT_ROUNDOFF * s128.abs()).all()), f"[dtypes] abs: {e_mag.max().item()}")  # 2 ulp
    a64 = torch.angle(s128)
    spacing = torch.as_tensor(np.spacing(a64.abs().float().cpu().numpy()), device=dev).double()
    e_ang = ((ang.larray.double() - a64).abs() / spacing).max().item()
    check(e_ang <= 4, f"[dtypes] angle: {e_ang} ulp")  # atan2f within 2 ulp, twice for margin
    check(torch.equal(cj.larray, sl.conj().resolve_conj()) and torch.equal(re.larray, sl.real)
          and torch.equal(im.larray, sl.imag), "[dtypes] conj/real/imag are not exact")
    p2 = (s128.abs() ** 2).sum().item()
    v_bound = (SUM_LAMBDA * math.sqrt(N_CX) + 3) * F32_UNIT_ROUNDOFF * p2  # |z|^2: two products and an add
    e_vd = abs(complex(vd.item()) - p2)
    check(e_vd <= v_bound, f"[dtypes] vdot(s, s) {vd.item()} vs {p2}: {e_vd} > {v_bound}")
    top_re = sl.real.max()
    top = complex(top_re.item(), sl.imag[sl.real == top_re].max().item())  # the largest real part, then imaginary
    check(complex(mx.item()) == top, f"[dtypes] lexicographic max {mx.item()} vs {top}")
    r = sl.flip(0)
    want_lt = (sl.real < r.real) | ((sl.real == r.real) & (sl.imag < r.imag))
    check(torch.equal(lt.larray, want_lt), "[dtypes] complex < is not lexicographic")
    del s, sl, s128, a64, spacing, r, want_lt, mag, ang, cj, re, im, s_rev, lt, ph, nr, ni
    parts = normal32(seed + 3, (2, CX_ROWS, F_DT))
    xc_h = parts[0] + np.complex64(1j) * parts[1]
    del parts
    X = ht.array(xc_h, split=0)
    G = step("conj(X).T @ X (complex)", lambda: ht.matmul(ht.conj(X).T, X))
    x128 = X.larray.to(torch.complex128)
    g_ref = x128.conj().T @ x128
    g_abs = x128.abs().T @ x128.abs()
    # each complex product a.b carries at most sqrt(5) u |a||b| (Brent, Percival, Zimmermann 2007); the real and
    # imaginary sums each the accumulation bound of terms bounded by |a||b|
    g_bound = (SUM_LAMBDA * math.sqrt(CX_ROWS) * math.sqrt(2) + math.sqrt(5)) * F32_UNIT_ROUNDOFF * g_abs
    e_g = (G.larray.to(torch.complex128) - g_ref).abs()
    check(G.dtype is ht.complex64 and bool((e_g <= g_bound).all()), f"[dtypes] X^H X: {(e_g / g_bound).max().item()}")
    print(f"[dtypes] complex64 signal of {N_CX} samples against complex128: abs within 2 ulp, angle within {e_ang:.1f} "
          f"ulp, conj/real/imag exact, vdot(s, s) {complex(vd.item())} vs {p2:.6f} (error {e_vd:.3e} <= {v_bound:.3e}), "
          f"the lexicographic max and < exact; conj(X).T @ X of {CX_ROWS} x {F_DT}: worst "
          f"{(e_g / g_bound).max().item():.3f} of its bound", flush=True)
    del X, G, x128, g_ref, g_abs, e_g
    torch.cuda.empty_cache()

    mark("complex")
    # ---- convolve: 2^26 samples, 1023 taps, three modes, against scipy's float64 fftconvolve
    a, v = ht.array(a_h, split=0), ht.array(taps)
    outs = {mode: step(f"convolve {mode}", lambda mode=mode: ht.convolve(a, v, mode)) for mode in ("full", "same",
                                                                                                   "valid")}
    for mode in ("full", "same", "valid"):
        warm[f"convolve {mode}"] = time_ms(lambda mode=mode: ht.convolve(a, v, mode), reps=5, warm=1)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        outs["same, TF32 on"] = step("convolve same, TF32 on", lambda: ht.convolve(a, v, "same"))
        check(torch.backends.cudnn.allow_tf32 is True, "[dtypes] convolve did not restore cuDNN's TF32 switch")
    finally:
        torch.backends.cudnn.allow_tf32 = before
    ref_full, t_scipy = pending.result()
    pool.shutdown()
    fft_err = 4 * math.log2(ref_full.size) * 2.0 ** -53 * np.linalg.norm(a_h.astype(np.float64)) * np.linalg.norm(taps)
    abs_full = ht.convolve(ht.abs(a).astype(ht.float64), ht.abs(v).astype(ht.float64)).larray  # sum |a||v|, float64
    spans = {"full": (0, N_CONV + M_CONV - 1), "same": ((M_CONV - 1) // 2, N_CONV), "valid": (M_CONV - 1,
                                                                                               N_CONV - M_CONV + 1)}
    conv_lines = []
    for name, r in outs.items():
        off, length = spans[name.split(",")[0]]
        check(r.dtype is ht.float32 and r.gshape == (length,) and r.split == 0, f"[dtypes] convolve {name} metadata")
        ref = torch.as_tensor(ref_full[off:off + length], device=dev)
        # M u sum|a||v| per output, plus the float64 FFT's own error, normwise c log2(L) u64 ||a|| ||v|| (c = 4)
        bound = M_CONV * F32_UNIT_ROUNDOFF * abs_full[off:off + length] + fft_err
        e = (r.larray.double() - ref).abs()
        check(bool((e <= bound).all()), f"[dtypes] convolve {name}: worst {(e / bound).max().item():.3f} of M u sum|a||v|")
        conv_lines.append(f"{name} worst {(e / bound).max().item():.3f} of the bound")
    del outs, abs_full, ref_full, a, v
    torch.cuda.empty_cache()
    flops = 2.0 * N_CONV * M_CONV
    print(f"[dtypes] convolve of {N_CONV} float32 samples with {M_CONV} windowed-sinc taps against scipy's float64 "
          f"fftconvolve ({t_scipy:.2f} s on 8 host threads, beside the card's work), M u sum|a||v| per output: " + ", ".join(conv_lines)
          + f"; bound of one call {flops / FP32_FLOP_PER_S * 1e3:.4f} ms ({flops:.3e} float32 flops)", flush=True)

    mark("convolve")
    # ---- pad's six new modes on a split array, against numpy
    p_h = normal32(seed + 5, (N_PAD, N_PAD))
    p = ht.array(p_h, split=0)
    pad_lines = []
    (b0, e0), (b1, e1) = PAD_WIDTH

    def border(a):
        """The padded entries: the first and last rows, then the first and last columns of the rows between."""
        mid = a[b0:a.shape[0] - e0]
        return [a[:b0], a[a.shape[0] - e0:], mid[:, :b1], mid[:, a.shape[1] - e1:]]

    for mode in PAD_MODES:
        r = step(f"pad {mode}", lambda mode=mode: ht.pad(p, PAD_WIDTH, mode))
        check(r.split == 0 and r.dtype is ht.float32 and r.gshape == (N_PAD + b0 + e0, N_PAD + b1 + e1),
              f"[dtypes] pad {mode} metadata")
        check(torch.equal(r.larray[b0:b0 + N_PAD, b1:b1 + N_PAD], p.larray), f"[dtypes] pad {mode} moved the data")
        got = np.concatenate([t.cpu().numpy().ravel() for t in border(r.larray)])
        want = np.pad(p_h, PAD_WIDTH, "constant" if mode == "empty" else mode)  # jnp's empty padding is zeros
        want = np.concatenate([w.ravel() for w in border(want)])
        e = ulps(got, want.astype(np.float64))
        # maximum/minimum/empty exact; median one rounding of a midpoint; linear_ramp numpy's float32 linspace against
        # one rounding of the float64 ramp; mean a float32 sum of 4096 terms in another order, 2 ulp of its magnitude
        limit = {"maximum": 0, "minimum": 0, "empty": 0, "median": 1, "linear_ramp": 2}.get(mode)
        if limit is None:
            e_abs = np.abs(got.astype(np.float64) - want)
            bnd = 2 * accumulation_bound(N_PAD, np.abs(p_h).sum(axis=0).max()) / N_PAD + 2 * F32_UNIT_ROUNDOFF * np.abs(want)
            check(bool(np.all(e_abs <= bnd)), f"[dtypes] pad mean: {e_abs.max()}")
            pad_lines.append(f"{mode} max abs {e_abs.max():.3e}")
        else:
            check(bool(np.all(e <= limit)), f"[dtypes] pad {mode}: {e.max()} ulp")
            pad_lines.append(f"{mode} {e.max():.0f} ulp")
    del p
    torch.cuda.empty_cache()
    print(f"[dtypes] pad of a split ({N_PAD}, {N_PAD}) float32 array by {PAD_WIDTH} against numpy: "
          + ", ".join(pad_lines), flush=True)
    mark("pad")
    print(f"[dtypes] host seconds per section, checks included: data before the path {t_host:.2f}, "
          + ", ".join(f"{k} {v:.2f}" for k, v in sections.items()), flush=True)
    print(f"[dtypes] per step, first calls, host s / CUDA-event ms ({smi}): "
          + ", ".join(f"{k} {h:.4f} s / {ev:.4f} ms" for k, (h, ev) in steps.items()), flush=True)
    print(f"[dtypes] warm, CUDA-event ms (median of 5, the fit of 3; {smi}): "
          + ", ".join(f"{k} {ms:.4f}" for k, ms in warm.items()), flush=True)
    return {k: launches.get(k, 0) for k in ("moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused",
                                             "threefry_bits")}


# ---- [stream]: the out-of-core path, one card --------------------------------------------------------------------
# [main]'s blob recipe from numpy (centres N(0, 8^2), unit noise, row c of the first K_MAIN in blob c) at N_MAIN x
# F_MAIN float32 (2 GiB), written as a classic netCDF CDF-2 file (CDF-1's offsets stop at 2 GiB) and streamed back in
# chunks of STREAM_CHUNK rows: 8 chunks a pass, 2 read ahead by the Prefetcher
STREAM_CHUNK, STREAM_DEPTH, STREAM_EPOCHS = 1 << 21, 2, 10
STREAM_FREE = 3 << 30  # bytes of free disk the phase needs: the 2 GiB file, the 0.3 GiB CSV, and room
STREAM_Q = (1.0, 25.0, 50.0, 75.0, 99.0)
STREAM_BINS = 64
N_CSV, CSV_CHUNK = 1 << 20, 1 << 18  # the CSV round trip: 2^20 x 32 rows (0.3 GB of text), 4 chunks a pass
HLL_DISTINCT = 1_000_003  # the HyperLogLog column: N_MAIN values with this many distinct ones
ZIPF_A, ZIPF_TOP = 1.5, 10  # the Count-Min column: Zipf(a) integers; the true top ZIPF_TOP must be among the candidates
STREAM_SEED_OFFSET = 100  # [stream]'s numpy streams start at --seed + this (the other phases keep theirs)
# Chan's merge in float32 of C chunk states: each merge rounds ~10 times on values bounded by the largest chunk mean
# M (delta, delta * n_b / n, the sum, and the chunk mean's own rounding), so |mean - ref| <= (10 C + 1) u M; M2's
# terms are positive, each merge rounding them ~8 times, and the delta^2 term carries the means' error:
# |var - ref| <= (8 C + 2) u var + 10 C u M^2
MERGE_MEAN_ROUNDINGS, MERGE_M2_ROUNDINGS = 10, 8


def stream_space(tag="[stream]", prefix="chip_smoke_stream_"):
    """A new directory with STREAM_FREE bytes free for a phase's stream files: in the temp directory, else in the
    repository's git-ignored chiprun_out/; fails naming what both have."""
    base = tempfile.gettempdir()
    free = shutil.disk_usage(base).free
    if free < STREAM_FREE:
        alt = os.path.join(ROOT, "chiprun_out")
        os.makedirs(alt, exist_ok=True)
        alt_free = shutil.disk_usage(alt).free
        check(alt_free >= STREAM_FREE, f"{tag} needs {STREAM_FREE} B free: {base} has {free}, {alt} {alt_free}")
        base = alt
    return tempfile.mkdtemp(prefix=prefix, dir=base)


def stream_blobs(seed):
    """[main]'s blob recipe with numpy: (x, member, centres), x float32 (N_MAIN, F_MAIN)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centres = (rng.standard_normal((K_MAIN, F_MAIN)) * 8.0).astype(np.float32)
    member = rng.integers(0, K_MAIN, N_MAIN)
    member[:K_MAIN] = np.arange(K_MAIN)

    def blobs(lo, hi, slab):
        slab += centres[member[lo:hi]]
        x[lo:hi] = slab

    x = np.empty((N_MAIN, F_MAIN), np.float32)
    normal32(seed + 1, (N_MAIN, F_MAIN), finish=blobs, out=x)
    return x, member, centres


def merge_bounds(x_dev, chunk, var):
    """The Chan-merge bounds above for the moments of the float32 (n, f) tensor ``x_dev`` streamed in ``chunk``-row
    chunks: (mean bound, var bound) per column."""
    import torch

    n = x_dev.shape[0]
    c = -(-n // chunk)
    means = torch.stack([x_dev[i:i + chunk].double().mean(dim=0) for i in range(0, n, chunk)])
    m = means.abs().amax(dim=0)
    u = F32_UNIT_ROUNDOFF
    return ((MERGE_MEAN_ROUNDINGS * c + 1) * u * m,
            (MERGE_M2_ROUNDINGS * c + 2) * u * var + MERGE_MEAN_ROUNDINGS * c * u * m * m)


def stream_phase(dev, seed, smi):
    """[stream]: the out-of-core path on one card, through the entry points a user calls. Blobs (2 GiB) -> ``save``
    as classic netCDF CDF-2 -> ``load`` split 0 -> a ``ChunkIterator`` over the file through a ``Prefetcher`` into
    ``StreamingMoments`` (``moments_onepass`` once per chunk) -> ``StreamingKMeans`` global and minibatch
    (``lloyd_fused`` once per chunk and epoch) -> the KLL ``percentile`` of the iterator, ``StreamingHistogram`` and
    ``StreamingCov`` -> ``HyperLogLog`` and ``CountMinTopK`` on integer columns -> a CSV round trip through the native
    parser and a pass over it -> the float16/bfloat16 ``rand``/``randn`` draws (``threefry_bits``' 16-bit kinds, bit
    for bit against the plain version). Every result is held against the in-memory path or float64 within the bounds
    stated beside it. Returns the kernels' launches over the streamed path."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import THREEFRY_KERNEL, forced_mode, lloyd_local, moments_local
    from heat_tpu_torch.core.kernels import threefry_bits, threefry_plain

    ht.use_device("gpu")
    steps, launched, lines = {}, {}, []
    seed = seed + STREAM_SEED_OFFSET

    def step(name, fn):
        """fn() with its host seconds, CUDA-event ms and the kernel launches it made."""
        torch.cuda.synchronize()
        before = dict(ht.LAUNCHES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        delta = {k: v - before.get(k, 0) for k, v in ht.LAUNCHES.items() if v != before.get(k, 0)}
        steps[name] = (time.perf_counter() - t0, a.elapsed_time(b), delta)
        for k, v in delta.items():
            launched[k] = launched.get(k, 0) + v
        return out

    def rate(name, nbytes, rows):
        host = steps[name][0]
        return f"{nbytes / host / 1e9:.3f} GB/s, {rows / host:.4e} rows/s"

    d = stream_space()
    try:
        t0 = time.perf_counter()
        x_h, member_h, _ = stream_blobs(seed)
        t_data = time.perf_counter() - t0
        path = os.path.join(d, "x.nc")
        x = ht.array(x_h, split=0)
        nbytes = x_h.nbytes
        # the in-memory references first: their launches are not the streamed path's
        mu_mem, var_mem = ht.mean(x, axis=0).larray.double(), ht.var(x, axis=0).larray.double()
        init = ht.array(x_h[:K_MAIN])
        km_mem = ht.cluster.KMeans(K_MAIN, init=init, max_iter=STREAM_EPOCHS, tol=None).fit(x)
        torch.cuda.synchronize()
        ht.kernels.reset_kernel_stats()
        step("save (netCDF CDF-2)", lambda: ht.save(x, path, "x", format="NETCDF3_64BIT"))
        check(os.path.getsize(path) >= nbytes, f"[stream] the file holds {os.path.getsize(path)} B")
        y = step("load split 0", lambda: ht.load(path, "x", split=0))
        check(y.gshape == x.gshape and y.split == 0 and y.dtype is ht.float32 and y.larray.is_cuda, "[stream] load")
        dx, dy = _digest(x.larray), _digest(y.larray)
        check(dx == dy, f"[stream] the loaded array's digest {dy} is not the saved one's {dx}")
        del y
        torch.cuda.empty_cache()
        lines.append(f"save {rate('save (netCDF CDF-2)', nbytes, N_MAIN)}, load {rate('load split 0', nbytes, N_MAIN)}; "
                     f"digest {dx} equal")

        it = ht.stream.ChunkIterator(path, STREAM_CHUNK, dataset="x")
        check(len(it) == N_MAIN // STREAM_CHUNK, f"[stream] {len(it)} chunks")
        ht.stream.reset_stream_stats()

        def moments_pass():
            m = ht.stream.StreamingMoments()
            for c in ht.stream.Prefetcher(it, depth=STREAM_DEPTH):
                m.update(c)
            return m

        sm = step("StreamingMoments pass", moments_pass)
        stats = dict(ht.STREAM_STATS)
        n_chunks = len(it)
        check(steps["StreamingMoments pass"][2] == {"moments_onepass": n_chunks},
              f"[stream] one moments_onepass launch per chunk: {steps['StreamingMoments pass'][2]}")
        check(ht.KERNEL_STATS.get("moments_onepass.cuda") == n_chunks and stats["chunks"] == n_chunks
              and stats["bytes_read"] == nbytes, f"[stream] routes {dict(ht.KERNEL_STATS)}, STREAM_STATS {stats}")
        mb, vb = merge_bounds(x.larray, STREAM_CHUNK, var_mem)
        e_mean, e_var = (sm.mean.larray.double() - mu_mem).abs(), (sm.var.larray.double() - var_mem).abs()
        check(bool((e_mean <= mb).all()) and bool((e_var <= vb).all()),
              f"[stream] moments vs in-memory: mean {(e_mean / mb).max().item():.3f}, var "
              f"{(e_var / vb).max().item():.3f} of the bound")
        # and against float64, as [dist] holds its streamed moments
        x64 = x.larray.double()
        mu64, var64 = x64.mean(dim=0), x64.var(dim=0, unbiased=False)
        del x64
        mb64, vb64 = merge_bounds(x.larray, STREAM_CHUNK, var64)
        e_mean64, e_var64 = (sm.mean.larray.double() - mu64).abs(), (sm.var.larray.double() - var64).abs()
        check(bool((e_mean64 <= mb64).all()) and bool((e_var64 <= vb64).all()),
              f"[stream] moments vs float64: mean {(e_mean64 / mb64).max().item():.3f}, var "
              f"{(e_var64 / vb64).max().item():.3f} of the bound")
        # the two kernels on the path's own tensors: the file's first window, read and staged as the pass does
        chunk = it._stage(next(it._windows())).larray
        check(chunk.shape == (STREAM_CHUNK, F_MAIN) and chunk.is_cuda, f"[stream] the staged chunk {chunk.shape}")
        l_mom = moments_vs_plain("[stream] (file chunk)", chunk)
        one_ms = time_ms(lambda: moments_local(x.larray[:STREAM_CHUNK]), reps=5, warm=1)
        busy = n_chunks * one_ms / 1e3 / steps["StreamingMoments pass"][0]
        lines.append(f"StreamingMoments pass {rate('StreamingMoments pass', nbytes, N_MAIN)}; mean worst "
                     f"{(e_mean / mb).max().item():.3f}, var {(e_var / vb).max().item():.3f} of the merge bound (vs "
                     f"float64 {(e_mean64 / mb64).max().item():.3f}, {(e_var64 / vb64).max().item():.3f}); {l_mom} on "
                     f"the file's first chunk; "
                     f"STREAM_STATS {stats}; moments_onepass {one_ms:.4f} ms a chunk: device busy share {busy:.4f}")

        # StreamingKMeans: the global fit is KMeans with the sums re-associated: centres within the accumulation
        # bound of the per-cluster sums (both within lambda sqrt(n_c) u sum|x| of the exact, so twice that apart)
        fit = step("StreamingKMeans global fit", lambda: ht.cluster.StreamingKMeans(
            K_MAIN, init=init, max_iter=STREAM_EPOCHS, tol=None).fit(it, prefetch_depth=STREAM_DEPTH))
        check(steps["StreamingKMeans global fit"][2] == {"lloyd_fused": n_chunks * STREAM_EPOCHS},
              f"[stream] one lloyd_fused launch per chunk and epoch: {steps['StreamingKMeans global fit'][2]}")
        check(fit.n_iter_ == STREAM_EPOCHS, f"[stream] {fit.n_iter_} epochs")
        lab = km_mem.labels_.larray
        onehot = torch.nn.functional.one_hot(lab.long(), K_MAIN).to(torch.float32)
        abs_sums = (onehot.T @ x.larray.abs()).double()
        counts = onehot.sum(dim=0).double()
        c_bound = (2 * SUM_LAMBDA * torch.sqrt(counts)[:, None] * F32_UNIT_ROUNDOFF * abs_sums / counts[:, None]
                   + 2 * F32_UNIT_ROUNDOFF * km_mem.cluster_centers_.larray.double().abs())
        e_c = (fit.cluster_centers_.larray.double() - km_mem.cluster_centers_.larray.double()).abs()
        check(bool((e_c <= c_bound).all()), f"[stream] centres vs KMeans: {(e_c / c_bound).max().item():.3f} of the bound")
        pred = fit.predict(x).larray
        check(torch.equal(pred, km_mem.predict(x).larray), "[stream] the streamed fit's labels differ from KMeans'")
        member_d = torch.as_tensor(member_h, device=dev)
        acc, _ = matched_labels(pred, member_d, K_MAIN, what="[stream] StreamingKMeans labels vs the blobs")
        check(acc > DT_ACC, f"[stream] StreamingKMeans agrees with the blobs on {acc} of the rows")
        mini = step("StreamingKMeans minibatch", lambda: ht.cluster.StreamingKMeans(
            K_MAIN, init=init, max_iter=1, algorithm="minibatch").fit(it, prefetch_depth=STREAM_DEPTH))
        check(steps["StreamingKMeans minibatch"][2] == {"lloyd_fused": n_chunks},
              f"[stream] minibatch: one launch per chunk {steps['StreamingKMeans minibatch'][2]}")
        acc_mb, _ = matched_labels(mini.predict(x).larray, member_d, K_MAIN, what="[stream] minibatch labels")
        check(acc_mb > DT_ACC, f"[stream] minibatch agrees with the blobs on {acc_mb} of the rows")
        _, _, l_init = lloyd_vs_plain("[stream] (file chunk, init)", chunk, init.larray, STREAM_CHUNK)
        _, _, l_fit = lloyd_vs_plain("[stream] (file chunk, fitted)", chunk, fit.cluster_centers_.larray, STREAM_CHUNK)
        del chunk
        host_fit = steps["StreamingKMeans global fit"][0]
        lloyd_ms = time_ms(lambda: lloyd_local(x.larray[:STREAM_CHUNK], init.larray), reps=5, warm=1)
        lines.append(f"StreamingKMeans global {STREAM_EPOCHS} epochs {host_fit:.3f} s ({nbytes * STREAM_EPOCHS / host_fit / 1e9:.3f} "
                     f"GB/s read), centres worst {(e_c / c_bound).max().item():.3f} of the bound, labels equal "
                     f"KMeans', blobs {acc:.6f}; lloyd_fused {lloyd_ms:.4f} ms a chunk: device busy share "
                     f"{n_chunks * STREAM_EPOCHS * lloyd_ms / 1e3 / host_fit:.4f}; minibatch one pass, blobs {acc_mb:.6f}; "
                     f"on the file's first chunk from the init centres {l_init}; from the fitted centres {l_fit}")
        del km_mem, onehot, lab, pred, mini

        # KLL percentiles of the iterator: each within the sketch's own eps of rank against the exact ranks
        qs = step("percentile (KLL)", lambda: ht.percentile(it, list(STREAM_Q)))
        # the same pass folded into a sketch of its own: percentile(it) must answer as it does, so its eps bounds
        # the answer
        sk = ht.stream.KLLSketch()
        for c in ht.stream.Prefetcher(it, depth=STREAM_DEPTH):
            sk.update(c)
        check(torch.equal(sk.percentile(list(STREAM_Q)).larray, qs.larray),
              "[stream] percentile(it) differs from a KLLSketch folded over the same pass")
        flat = x.larray.reshape(-1)
        n_all = flat.numel()
        worst = 0.0
        for q, v in zip(STREAM_Q, qs.larray.tolist()):
            lo, hi = int((flat < v).sum()), int((flat <= v).sum())
            target = q / 100 * (n_all - 1)
            err = max(0.0, lo - target, target - hi) / n_all
            check(err <= sk.eps, f"[stream] KLL percentile {q}: rank error {err} > eps {sk.eps}")
            worst = max(worst, err / sk.eps)
        lines.append(f"KLL percentiles {[round(v, 4) for v in qs.larray.tolist()]} at {list(STREAM_Q)}: rank error "
                     f"worst {worst:.3f} of eps {sk.eps:.5f}")

        # histogram and covariance in one pass
        lo_r, hi_r = float(flat.min()) - 1.0, float(flat.max()) + 1.0
        del flat

        def hist_cov_pass():
            h, cv = ht.stream.StreamingHistogram(STREAM_BINS, (lo_r, hi_r)), ht.stream.StreamingCov()
            for c in ht.stream.Prefetcher(it, depth=STREAM_DEPTH):
                h.update(c)
                cv.update(c)
            return h, cv

        hist, cov = step("StreamingHistogram + StreamingCov pass", hist_cov_pass)
        counts_h = hist.hist.larray.long()
        check(int(counts_h.sum()) == N_MAIN * F_MAIN, f"[stream] histogram counts sum to {int(counts_h.sum())}")
        d64 = x.larray.double() - mu64
        cov64 = (d64.T @ d64) / (N_MAIN - 1)
        a_abs = d64.abs().T @ d64.abs() / (N_MAIN - 1)
        del d64
        # each chunk's float32 co-moment of n_b rows is within (lambda sqrt(n_b) + 4) u sum|d_i d_j| of its exact
        # value (the products and the centring rounded too), and C merges add 3 roundings each of the same terms
        cv_bound = (SUM_LAMBDA * math.sqrt(STREAM_CHUNK) + 4 + 3 * n_chunks) * F32_UNIT_ROUNDOFF * a_abs
        e_cov = (cov.cov.larray.double() - cov64).abs()
        check(bool((e_cov <= cv_bound).all()), f"[stream] cov: {(e_cov / cv_bound).max().item():.3f} of the bound")
        lines.append(f"StreamingHistogram ({STREAM_BINS} bins over [{lo_r:.3f}, {hi_r:.3f}]) counts sum to "
                     f"{N_MAIN * F_MAIN} exactly; StreamingCov vs float64 worst {(e_cov / cv_bound).max().item():.3f} "
                     f"of the bound; pass {rate('StreamingHistogram + StreamingCov pass', nbytes, N_MAIN)}")
        del cov64, a_abs, e_cov, hist, cov

        # sketches of integer columns, streamed from host arrays
        col = (np.random.default_rng(seed + 2).permutation(N_MAIN) % HLL_DISTINCT).astype(np.float32)[:, None]
        hll = step("HyperLogLog", lambda: _fold_all(ht, ht.stream.HyperLogLog(), col))
        est = hll.distinct()
        check(abs(est - HLL_DISTINCT) <= 3 * hll.rel_error * HLL_DISTINCT,
              f"[stream] HyperLogLog {est} vs {HLL_DISTINCT} (3 sigma {3 * hll.rel_error * HLL_DISTINCT})")
        zipf = np.random.default_rng(seed + 3).zipf(ZIPF_A, N_MAIN)
        zipf = np.minimum(zipf, 1 << 20).astype(np.float32)[:, None]
        cm = step("CountMinTopK", lambda: _fold_all(ht, ht.stream.CountMinTopK(), zipf))
        vals, cnts = np.unique(zipf, return_counts=True)
        top = set(vals[np.argsort(-cnts, kind="stable")][:ZIPF_TOP].tolist())
        cands = set(cm.topk()[0].larray.tolist())
        check(top <= cands, f"[stream] Count-Min candidates miss the true top {ZIPF_TOP}: {sorted(top - cands)}")
        lines.append(f"HyperLogLog {est:.1f} distinct of {HLL_DISTINCT} ({(est - HLL_DISTINCT) / HLL_DISTINCT:+.4f}, 3 "
                     f"sigma {3 * hll.rel_error:.4f}); CountMinTopK holds the true top {ZIPF_TOP} of {N_MAIN} Zipf({ZIPF_A}) "
                     f"values")
        del col, zipf

        # CSV: 2^20 rows through save_csv and the native parser; a pass over it (loadtxt's windows, heat_tpu's route)
        csv_path = os.path.join(d, "x.csv")
        xs = ht.array(x_h[:N_CSV], split=0)
        step("save_csv", lambda: ht.save_csv(xs, csv_path))
        ht.kernels.reset_kernel_stats()
        yc = step("load_csv", lambda: ht.load_csv(csv_path, split=0))
        check(ht.KERNEL_STATS.get("csv.native") == 1 and "csv.python" not in ht.KERNEL_STATS,
              f"[stream] load_csv's route {dict(ht.KERNEL_STATS)}")
        # %f keeps 6 decimals (|error| <= 5e-7), then one rounding to float32
        e_csv = (yc.larray.double() - xs.larray.double()).abs()
        c_bnd = 5e-7 + F32_UNIT_ROUNDOFF * xs.larray.double().abs() + 1e-12
        check(bool((e_csv <= c_bnd).all()), f"[stream] CSV values: {(e_csv / c_bnd).max().item():.3f} of the bound")
        csv_it = ht.stream.ChunkIterator(csv_path, CSV_CHUNK)

        def csv_pass():
            m = ht.stream.StreamingMoments()
            for c in ht.stream.Prefetcher(csv_it, depth=STREAM_DEPTH):
                m.update(c)
            return m

        smc = step("StreamingMoments over the CSV", csv_pass)
        check(steps["StreamingMoments over the CSV"][2] == {"moments_onepass": N_CSV // CSV_CHUNK},
              f"[stream] CSV pass launches {steps['StreamingMoments over the CSV'][2]}")
        mu_c, var_c = ht.mean(yc, axis=0).larray.double(), ht.var(yc, axis=0).larray.double()
        mbc, vbc = merge_bounds(yc.larray, CSV_CHUNK, var_c)
        check(bool(((smc.mean.larray.double() - mu_c).abs() <= mbc).all())
              and bool(((smc.var.larray.double() - var_c).abs() <= vbc).all()), "[stream] CSV pass moments")
        l_csv = moments_vs_plain("[stream] (CSV chunk)", csv_it._stage(next(csv_it._windows())).larray)
        csv_bytes = os.path.getsize(csv_path)
        lines.append(f"CSV {N_CSV} x {F_MAIN} ({csv_bytes} B): save_csv {steps['save_csv'][0]:.3f} s, load_csv (native) "
                     f"{rate('load_csv', csv_bytes, N_CSV)}, values within the %f bound; a pass of {N_CSV // CSV_CHUNK} "
                     f"chunks (loadtxt windows) {rate('StreamingMoments over the CSV', csv_bytes, N_CSV)}; {l_csv} on "
                     f"its first chunk")
        del xs, yc, smc

        # 16-bit draws: rand/randn in float16 and bfloat16 through threefry_bits' 16-bit kinds, one launch each,
        # against the plain version from the same state, bit for bit
        clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                         capture_output=True, text=True, check=True).stdout.split()[0])
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        int_rate = INT32_OPS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
        n16 = N_MAIN * F_MAIN
        draw_lines = []
        ht.random.seed(seed)
        for fn in ("rand", "randn"):
            for tname in ("float16", "bfloat16"):
                state = ht.random.get_state()
                r = step(f"{fn} {tname}", lambda: getattr(ht.random, fn)(N_MAIN, F_MAIN, dtype=getattr(ht, tname),
                                                                         split=0))
                check(steps[f"{fn} {tname}"][2] == {"threefry_bits": 1} and r.dtype is getattr(ht, tname),
                      f"[stream] {fn} {tname}: {steps[f'{fn} {tname}'][2]}, {r.dtype}")
                after = ht.random.get_state()
                ht.random.set_state(state)
                with forced_mode(THREEFRY_KERNEL, "torch"):
                    r0 = getattr(ht.random, fn)(N_MAIN, F_MAIN, dtype=getattr(ht, tname), split=0)
                check(ht.random.get_state() == after, "[stream] the plain draw moved the counter otherwise")
                check(torch.equal(r.larray.view(torch.int16), r0.larray.view(torch.int16)),
                      f"[stream] {fn} {tname}: threefry_bits differs from its plain version")
                key = ht.random._fold_in(ht.random._prng_key(state[1]), state[2] & 0x7FFFFFFF)
                kind = ("uniform" if fn == "rand" else "normal") + ("16" if tname == "float16" else "bf16")
                layout = ht.random.chunk_layout((N_MAIN, F_MAIN), None, 0, 0)
                lo = ht.random._rounded(0.0 if fn == "rand" else -1.0 + (2.0 ** -11 if tname == "float16" else 2.0 ** -8),
                                        getattr(ht, tname))
                scale = ht.random._rounded(ht.random._rounded(1.0, getattr(ht, tname)) - lo, getattr(ht, tname))
                k_ms = time_ms(lambda: threefry_bits(key, layout, kind, dev, lo, scale), reps=10, warm=2)
                p_ms = time_ms(lambda: threefry_plain(key, layout, kind, dev, lo, scale), reps=2, warm=1)
                check(torch.equal(threefry_bits(key, layout, kind, dev, lo, scale).view(torch.int16),
                                  r.larray.reshape(-1).view(torch.int16)), f"[stream] {kind}: the draw's own key")
                # the bound: 2 B written per element (nothing read); the INT32 count of THREEFRY_INT32_OPS at 64 a
                # clock per SM is an estimate beside it, no bound: the compiler issues some integer adds on the FMA
                # pipe and merges others (IADD3, LOP3), and the uniform kinds run faster than it
                b_bytes = n16 * 2 / HBM_BYTES_PER_S * 1e3
                b_int = THREEFRY_INT32_OPS * n16 / int_rate * 1e3
                draw_lines.append(f"{fn} {tname} ({kind}) kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                                  f"{b_bytes:.4f} ms (bytes; share {b_bytes / k_ms:.3f}), INT32 estimate {b_int:.4f} ms "
                                  f"({b_int / k_ms:.3f} of the kernel's time)")
                del r, r0
        lines.append(f"16-bit draws of ({N_MAIN}, {F_MAIN}), each bit-identical to the plain version: "
                     + "; ".join(draw_lines))
        del x, init, it, sm, fit
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for line in lines:
        print(f"[stream] {line}", flush=True)
    print(f"[stream] per step, host s / CUDA-event ms / launches ({smi}): "
          + ", ".join(f"{k} {h:.4f} s / {ev:.4f} ms / {la}" for k, (h, ev, la) in steps.items()), flush=True)
    print(f"[stream] launches over the streamed path {launched}; host data {t_data:.2f} s", flush=True)
    return {k: launched.get(k, 0) for k in ("moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused",
                                             "threefry_bits")}


def _fold_all(ht, sketch, col):
    """``sketch`` updated with every STREAM_CHUNK-row chunk of the host column ``col``."""
    for c in ht.stream.ChunkIterator(col, STREAM_CHUNK):
        sketch.update(c)
    return sketch


# ---- [dist]: the main path over torch.distributed, one process per card ------------------------
DIST_SEED, DIST_QR_SEED, DIST_RIDGE_SEED, DIST_LU_SEED, DIST_SVD_SEED = 7, 8, 9, 10, 14
N_DIST_SLICE = 1 << 20  # rows of z in the resplit round trip
# the kernel-ridge path in [dist]: 4096 rows per card (n = 16384 at four cards: K is 1 GiB, 256 MiB per card);
# cholesky's tiles_per_proc = 4 makes its panels 4096 / 4 = 1024 = MAX_FUSED_N rows, so every diagonal block
# runs chol_panel_fused above one card (at one card n = 4096 > MAX_FUSED_N takes cholesky_ex)
N_RIDGE_CARD, RIDGE_TILES = 4096, 4
# lstsq's QR route across ranks needs eps m < 1 (see _lstsq_check): 2^20 rows per card keeps m <= 2^22 up to
# four cards, where [dist]'s svd at N_SVD rows per card (m = 2^24 at four cards) cuts every singular value
N_LSTSQ_CARD = 1 << 20


def _dist_data(ht, world):
    """The [dist] path's data, the same global arrays at any world size (the
    port's split draws are split-invariant): 8 Gaussian blobs of
    N_MAIN * world rows x F_MAIN, row i of the first K_MAIN in blob i, and
    N_QUERY held-out rows from the same blobs."""
    import torch

    n = N_MAIN * world
    ht.random.seed(DIST_SEED)
    true = ht.random.randn(K_MAIN, F_MAIN) * 8.0
    member = ht.random.randint(0, K_MAIN, size=(n,), split=0, dtype=ht.int64)
    off = member.comm.chunk(member.gshape, 0)[0]
    if off < K_MAIN:
        member.larray[: K_MAIN - off] = torch.arange(off, K_MAIN, device=member.larray.device)
    x = ht.random.randn(n, F_MAIN, split=0) + ht.DNDarray(true.larray[member.larray], gshape=(n, F_MAIN), split=0)
    member_q = ht.random.randint(0, K_MAIN, size=(N_QUERY,), split=0, dtype=ht.int64)
    xq = ht.random.randn(N_QUERY, F_MAIN, split=0) + ht.DNDarray(
        true.larray[member_q.larray], gshape=(N_QUERY, F_MAIN), split=0)
    return true, member, x, member_q, xq


def _dist_qr_data(ht, world):
    ht.random.seed(DIST_QR_SEED)
    return ht.random.randn(N_QR * world, F_QR, split=0)


def _ceil_div_map(gshape, split, world):
    import numpy as np

    out = np.array([list(gshape)] * world, dtype=np.int64)
    n = gshape[split]
    block = -(-n // world)
    for r in range(world):
        start = min(r * block, n)
        out[r, split] = min(start + block, n) - start
    return out


def _dist_rank(rank, world, store, out_dir, seed=0):
    """One rank of the [dist] phase: the main path on this rank's card over
    NCCL, its checks that need no single-process reference, and its times;
    what the parent compares goes to ``out_dir/rank{rank}.pt``."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import COLLECTIVES, RECEIVED

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ht.init_distributed(backend="nccl", init_method=f"file://{store}", world_size=world, rank=rank,
                        local_rank=rank, timeout=900)
    comm = ht.get_comm()
    dev = ht.get_device().torch_device
    check(comm.size == world and comm.rank == rank and comm.backend == "nccl", f"group {comm}")
    check(ht.get_device() == ht.Device("gpu", rank) and torch.cuda.current_device() == rank, f"device {ht.get_device()}")

    def say(msg):
        print(f"[dist r{rank}] {msg}", flush=True)

    def sync():
        torch.cuda.synchronize()
        comm.barrier()

    def timed(fn):
        """(result, host s, CUDA-event ms) of one call, all ranks started
        together; ``timed.collectives`` holds what the call itself ran."""
        sync()
        before = {k: dict(v) for k, v in COLLECTIVES.items()}
        before_recv = dict(RECEIVED)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        timed.collectives = {
            k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v} for k, v in COLLECTIVES.items()
            if v["calls"] != before.get(k, {}).get("calls", 0)
        }
        timed.received = {k: v - before_recv.get(k, 0) for k, v in RECEIVED.items() if v != before_recv.get(k, 0)}
        return out, host, a.elapsed_time(b)

    say(f"{torch.cuda.get_device_name(rank)} cuda:{rank}, world size {comm.size}, backend {comm.backend}")
    true, member, x, member_q, xq = _dist_data(ht, world)
    want_map = _ceil_div_map(x.gshape, 0, world)
    check(np.array_equal(x.lshape_map, want_map) and tuple(x.larray.shape) == tuple(want_map[rank]),
          f"x lshape_map {x.lshape_map.tolist()}")
    say(f"x {x.gshape} split 0, lshape_map {x.lshape_map[:, 0].tolist()} rows; queries {xq.lshape_map[:, 0].tolist()}")
    torch.cuda.empty_cache()

    # ---- the path, counts zeroed just before and read just after
    sync()
    ht.kernels.reset_kernel_stats()
    t_path = time.perf_counter()
    (mu, sd), t_stats, ev_stats = timed(lambda: (ht.mean(x, axis=0), ht.std(x, axis=0)))
    z = (x - mu) / sd
    init = z[:K_MAIN].resplit(None)
    km, t_fit, ev_fit = timed(lambda: ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(z))
    fit_coll = timed.collectives
    zq = (xq - mu) / sd
    pred = km.predict(zq)
    train, train_labels = z[:N_TRAIN], member[:N_TRAIN]
    clf = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, train_labels)
    knn_pred, t_knn, ev_knn = timed(lambda: clf.predict(zq))
    sync()
    path_s = time.perf_counter() - t_path
    launches, stats, colls = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS), {k: dict(v) for k, v in COLLECTIVES.items()}
    say(f"launches {launches} KERNEL_STATS {stats}")
    say(f"COLLECTIVES of the path {colls}")
    per_iter = {k: {f: v[f] / (ITERS + 1) for f in v} for k, v in fit_coll.items()}
    say(f"COLLECTIVES of the fit {fit_coll}: per Lloyd step (30 iterations + the inertia pass) {per_iter}")
    check(launches["moments_onepass"] == 1 and stats.get("moments_onepass.cuda") == 2,
          f"one moments launch per rank should serve mean and std: {launches}, {stats}")
    check(launches["lloyd_fused"] == ITERS + 1 and stats.get("lloyd_fused.resident") == ITERS + 1,
          f"lloyd launches per rank {launches['lloyd_fused']} != {ITERS + 1}, or not all resident: {stats}")
    check(launches["topk_distance"] == 1 and stats.get("topk_distance.cuda") == 1, f"topk launches {launches}, {stats}")
    check(not any(k.endswith(".torch") for k in stats), f"a plain version ran on the path: {stats}")
    packed = (K_MAIN * F_MAIN + K_MAIN + 1) * 4
    check(fit_coll == {"allreduce": {"calls": ITERS + 1, "bytes": (ITERS + 1) * packed}},
          f"the fit should run one allreduce of {packed} B per Lloyd step and nothing else: {fit_coll}")
    check(km.labels_.split == 0 and km.cluster_centers_.split is None and pred.split == 0 and knn_pred.split == 0,
          "result splits")
    check(np.array_equal(km.labels_.lshape_map, _ceil_div_map((N_MAIN * world,), 0, world)), "labels lshape_map")
    say(f"mean+std {t_stats:.4f} s host, {ev_stats:.4f} ms events; first fit {t_fit:.4f} s ({ITERS / t_fit:.1f} it/s); "
        f"kNN predict {t_knn:.4f} s host, {ev_knn:.4f} ms events; whole path {path_s:.3f} s")

    # ---- replicated results bit-identical on every rank
    def same_everywhere(t, name):
        parts = comm.allgather(t.contiguous().unsqueeze(0), 0, [1] * world)
        check(all(torch.equal(parts[r], parts[0]) for r in range(world)), f"{name} differs between ranks")

    for name, t in (("mean", mu.larray), ("std", sd.larray), ("centers", km.cluster_centers_.larray),
                    ("inertia", torch.tensor([km.inertia_], device=dev))):
        same_everywhere(t, name)
    acc = comm.allreduce((knn_pred.larray == member_q.larray).sum()).item() / N_QUERY
    check(acc > 0.999, f"kNN predict accuracy against the blobs {acc}")

    # ---- warm times
    _, t_warm, ev_warm = timed(lambda: ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(z))
    _, t_knn_w, ev_knn_w = timed(lambda: clf.predict(zq))
    _, t_stats_w, ev_stats_w = timed(lambda: (ht.mean(x, axis=0), ht.std(x, axis=0)))
    d_nn, i_nn = ht.spatial.nearest_neighbors(zq, train, KNN_K)  # for the parent's index check; not on the path
    sl = z[:N_DIST_SLICE]
    rt, t_rs, ev_rs = timed(lambda: sl.resplit(1).resplit(None))
    check(rt.split is None and rt.gshape == sl.gshape, "resplit round trip metadata")
    off, lsh, _ = comm.chunk(sl.gshape, 0)
    check(torch.equal(rt.larray[off : off + lsh[0]], sl.larray), "resplit 0 -> 1 -> None changed the values")
    same_everywhere(rt.larray, "resplit round trip")
    say(f"warm fit {t_warm:.4f} s host ({ITERS / t_warm:.1f} it/s), {ev_warm:.4f} ms events; warm kNN predict "
        f"{t_knn_w:.4f} s, {ev_knn_w:.4f} ms events; warm mean+std {t_stats_w:.4f} s, {ev_stats_w:.4f} ms events; "
        f"resplit 0 -> 1 -> None of {sl.gshape} {t_rs:.4f} s, {ev_rs:.4f} ms events")
    result = {
        "rank": rank, "mu": mu.larray.cpu(), "sd": sd.larray.cpu(), "centers": km.cluster_centers_.larray.cpu(),
        "inertia": km.inertia_, "labels": km.labels_.larray.to(torch.int8).cpu(), "pred": pred.larray.cpu(),
        "knn_pred": knn_pred.larray.cpu(), "d_nn": d_nn.larray.cpu(), "i_nn": i_nn.larray.cpu(),
        "launches": launches, "stats": stats, "fit_collectives": fit_coll,
    }
    del x, z, zq, train, clf, rt, sl, d_nn, i_nn, km, member
    torch.cuda.empty_cache()

    # ---- tall-skinny qr + matmul: checks computed across ranks, Q never gathered
    A = _dist_qr_data(ht, world)
    torch.cuda.empty_cache()
    check(np.array_equal(A.lshape_map, _ceil_div_map(A.gshape, 0, world)), "A lshape_map")
    ht.kernels.reset_kernel_stats()
    (Q, R), t_qr, ev_qr = timed(lambda: ht.linalg.qr(A))
    qr_routes = {k: v for k, v in ht.KERNEL_STATS.items() if k.startswith("qr.")}
    qr_coll = timed.collectives
    G, t_mm, ev_mm = timed(lambda: ht.matmul(A.T, A))
    check(Q.split == 0 and R.split is None and G.split is None and Q.gshape == A.gshape and R.gshape == (F_QR, F_QR),
          "qr / matmul metadata")
    a_l, q_l, r64 = A.larray, Q.larray, R.larray.double()
    resid, a_max = torch.zeros((), dtype=torch.float64, device=dev), torch.zeros((), dtype=torch.float64, device=dev)
    qtq, gram = torch.zeros(F_QR, F_QR, dtype=torch.float64, device=dev), torch.zeros_like(r64)
    for r0 in range(0, a_l.shape[0], QR_CHUNK):
        qc, ac = q_l[r0 : r0 + QR_CHUNK].double(), a_l[r0 : r0 + QR_CHUNK].double()
        resid = torch.maximum(resid, (qc @ r64 - ac).abs().max())
        a_max = torch.maximum(a_max, ac.abs().max())
        qtq += qc.T @ qc
        gram += ac.T @ ac
        del qc, ac
    resid = (comm.allreduce(resid, "max") / comm.allreduce(a_max, "max")).item()
    ortho = (comm.allreduce(qtq) - torch.eye(F_QR, dtype=torch.float64, device=dev)).abs().max().item()
    gram = comm.allreduce(gram)
    g_diff = (G.larray.double() - gram).abs().max().item() / gram.abs().max().item()
    check(resid <= QR_RESID_RTOL, f"distributed ||QR - A||max/||A||max = {resid}")
    check(ortho <= QR_ORTHO_ATOL, f"distributed ||QᵀQ - I||max = {ortho}")
    check(g_diff <= QR_GRAM_RTOL, f"matmul(A.T, A) vs float64 Gram: {g_diff}")
    same_everywhere(R.larray, "R")
    same_everywhere(G.larray, "A.T @ A")
    say(f"qr of {A.gshape} split 0 (lshape_map {A.lshape_map[:, 0].tolist()} rows): local route {qr_routes}, "
        f"COLLECTIVES {qr_coll}; {t_qr:.4f} s host, {ev_qr:.4f} ms events; ||QR - A||max/||A||max {resid:.3e}, "
        f"||QᵀQ - I||max {ortho:.3e}; matmul(A.T, A) {t_mm:.4f} s host, {ev_mm:.4f} ms events, vs float64 Gram "
        f"{g_diff:.3e}")
    _, t_qr_w, ev_qr_w = timed(lambda: ht.linalg.qr(A))
    _, t_mm_w, ev_mm_w = timed(lambda: ht.matmul(A.T, A))
    say(f"warm qr {t_qr_w:.4f} s host, {ev_qr_w:.4f} ms events; warm matmul(A.T, A) {t_mm_w:.4f} s, {ev_mm_w:.4f} ms")
    result.update(R=R.larray.cpu(), qr_resid=resid, qr_ortho=ortho, gram_diff=g_diff, qr_routes=qr_routes)
    del A, Q, R, G, a_l, q_l, r64, qtq, gram
    torch.cuda.empty_cache()
    result["ridge"], (K, yv, alpha) = _dist_ridge(ht, world, rank, timed, same_everywhere, say, out_dir)
    result["lu"] = _dist_linalg(ht, world, rank, K, yv, alpha, timed, same_everywhere, say)
    del K, yv, alpha
    torch.cuda.empty_cache()
    result["svd"] = _dist_svd(ht, world, rank, timed, same_everywhere, say)
    torch.cuda.empty_cache()
    result["spectral"] = _dist_spectral(ht, world, rank, timed, same_everywhere, say)
    torch.cuda.empty_cache()
    result["robust"] = _dist_robust(ht, world, rank, timed, same_everywhere, say)
    torch.cuda.empty_cache()
    result["dtypes"] = _dist_dtypes(ht, world, rank, timed, same_everywhere, say)
    torch.cuda.empty_cache()
    result["stream"] = _dist_stream(ht, world, rank, timed, same_everywhere, say, out_dir)
    torch.cuda.empty_cache()
    result["layout"] = _dist_layout(ht, world, rank, timed, same_everywhere, say, seed)
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    result["train"] = _dist_train(ht, world, rank, timed, same_everywhere, say, out_dir, seed)
    result["train"]["wall"] = time.perf_counter() - t_train
    torch.cuda.empty_cache()
    t_frame = time.perf_counter()
    result["frame"] = _dist_frame(ht, world, rank, timed, same_everywhere, say, seed)
    _dist_resilience(ht, world, rank, say, out_dir, seed)
    result["frame"]["wall"] = time.perf_counter() - t_frame
    torch.cuda.empty_cache()
    result["lazy"] = _dist_lazy(ht, world, rank, timed, same_everywhere, say, seed)
    t_serve = time.perf_counter()
    result["serve"] = _dist_serve(ht, world, rank, timed, same_everywhere, say, out_dir, seed)
    result["serve"]["wall"] = time.perf_counter() - t_serve
    times = torch.tensor([t_stats, t_fit, t_warm, t_knn, t_knn_w, t_stats_w, t_qr, t_qr_w, t_mm, t_mm_w, t_rs, path_s],
                         dtype=torch.float64, device=dev)
    result["times_max"] = comm.allreduce(times, "max").cpu().tolist()
    result["events"] = [ev_stats, ev_fit, ev_warm, ev_knn, ev_knn_w, ev_stats_w, ev_qr, ev_qr_w, ev_mm, ev_mm_w, ev_rs]
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    comm.barrier()
    torch.distributed.destroy_process_group()


def _gamma(k):
    """Higham's gamma_k = k u / (1 - k u) for float32."""
    return k * F32_UNIT_ROUNDOFF / (1 - k * F32_UNIT_ROUNDOFF)


def _dist_ridge(ht, world, rank, timed, same_everywhere, say, out_dir):
    """The kernel-ridge path across the ranks at N_RIDGE_CARD rows per card, with its launch counts zeroed just
    before and read just after; the checks that need no one-process reference (computed across ranks, L never
    gathered); this rank's rows of K and L go to ``out_dir`` for the parent's factor check."""
    import torch

    from heat_tpu_torch.core.kernels import MAX_FUSED_N, cholesky_local

    comm = ht.get_comm()
    dev = ht.get_device().torch_device
    n = N_RIDGE_CARD * world
    sigma = F_MAIN ** 0.5
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives}
        return out

    ht.kernels.reset_kernel_stats()
    ht.random.seed(DIST_RIDGE_SEED)
    X, yv = step("draw X, y", lambda: (ht.random.randn(n, F_MAIN, split=0), ht.random.randn(n, split=0)))
    mu, sd = step("mean+std", lambda: (ht.mean(X, axis=0), ht.std(X, axis=0)))
    Xs = (X - mu) / sd
    K0 = step("rbf", lambda: ht.spatial.rbf(Xs, Xs, sigma=sigma))
    K = step("+ eye", lambda: K0 + ht.eye(n, split=0))
    L = step("cholesky", lambda: ht.linalg.cholesky(K, tiles_per_proc=RIDGE_TILES))
    z1 = step("solve L", lambda: ht.linalg.solve_triangular(L, yv, lower=True))
    alpha = step("solve L.T", lambda: ht.linalg.solve_triangular(L.T, z1, lower=False))
    launches, stats = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS)
    bs = ht.factor_block_edge(K, RIDGE_TILES, -(-n // world))
    panels = -(-n // bs)
    say(f"ridge n={n} ({N_RIDGE_CARD} rows per card), cholesky panels of {bs} rows: launches {launches} "
        f"KERNEL_STATS {stats}")
    say("ridge per call: " + "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, COLLECTIVES "
                                       f"{v['collectives']}" for k, v in steps.items()))
    check(launches["threefry_bits"] == 2 and stats.get("threefry_bits.cuda") == 2, f"ridge draws {launches}")
    if world > 1:
        check(bs == MAX_FUSED_N and launches["chol_panel_fused"] == panels
              and stats.get("chol_panel_fused.cuda") == panels,
              f"every rank should factor each of the {panels} diagonal blocks with chol_panel_fused: {launches}, {stats}")
    else:
        check(stats.get("chol_panel_fused.fallback") == 1 and launches["chol_panel_fused"] == 0,
              f"one card: n = {n} > MAX_FUSED_N takes cholesky_ex: {stats}")
    check(not any(k.endswith(".torch") for k in stats), f"a plain version ran on the ridge path: {stats}")
    check(K.split == 0 and L.split == 0 and alpha.split == (0 if world > 1 else None) and L.gshape == (n, n),
          "ridge splits / shapes")

    # ||L L^T - K|| across ranks: L's row chunks rotate around the ring, block (r, q) = L_r L_q^T in float64.
    # Higham (2nd ed.) Thm 10.3: the computed factor of a symmetric positive definite K satisfies
    # L L^T = K + dK with |dK| <= gamma_{n+1} |L| |L^T|, and (|L| |L^T|)_ij <= |L_i| |L_j| = sqrt(K_ii K_jj)
    # (+ O(u)), at most max K_ii = ||K||max here (rbf <= 1 off the diagonal, 2 on it): the blocked schedule
    # computes the same inner products in another order, so ||dK||max / ||K||max <= gamma_{n+1}.
    counts = [int(c) for c in L.lshape_map[:, 0]]
    starts = [sum(counts[:q]) for q in range(world)]
    Lr, Kr = L.larray, K.larray
    check(bool(torch.isfinite(Lr).all()) and bool((torch.triu(Lr, diagonal=starts[rank] + 1) == 0).all()),
          "ridge L finite and lower")
    buf = torch.zeros((max(counts), n), dtype=Lr.dtype, device=dev)
    buf[: counts[rank]] = Lr
    dk_max, dk_f2 = torch.zeros((), dtype=torch.float64, device=dev), torch.zeros((), dtype=torch.float64, device=dev)
    for s_ in range(world):
        q = (rank + s_) % world
        if counts[q] and counts[rank]:
            d = Lr.double() @ buf[: counts[q]].double().T - Kr[:, starts[q] : starts[q] + counts[q]].double()
            dk_max = torch.maximum(dk_max, d.abs().max())
            dk_f2 += (d * d).sum()
            del d
        if s_ < world - 1:
            buf = comm.ring_shift(buf)
    del buf
    k_max = comm.allreduce(Kr.abs().max().double(), "max").item()
    k_inf = comm.allreduce(Kr.double().abs().sum(1).max(), "max").item()  # ||K||_inf >= ||K||_2
    recon = comm.allreduce(dk_max, "max").item() / k_max
    dk_fro = comm.allreduce(dk_f2).sqrt().item()
    check(recon <= _gamma(n + 1), f"ridge ||L L^T - K||max/||K||max = {recon} > gamma_(n+1) = {_gamma(n + 1)}")
    # ||K a - y|| / ||y||: K a - y = -dK' a with dK' the factorization's and the solves' backward errors, and
    # ||K^-1|| <= 1 (K = rbf + I, rbf positive semi-definite): the relative residual is at most ||dK'||_2
    a_full = alpha._logical().double()
    r2 = comm.allreduce(((Kr.double() @ a_full - yv.larray.double()) ** 2).sum())
    y2 = comm.allreduce((yv.larray.double() ** 2).sum())
    resid = (r2 / y2).sqrt().item()
    check(resid <= RIDGE_SOLVE_RTOL, f"ridge ||K alpha - y||/||y|| = {resid}")

    # rbf on the ring against the default route: each d2 = (|x|^2 + |y|^2) - 2 x.y is within
    # E = gamma_{f+2} (|x| + |y|)^2 of the exact one (see knn_check), so the two routes' d2 differ by at most
    # 2 E <= 2 gamma_{f+2} (2 max|x|)^2; exp(-d2 / (2 sigma^2)) moves by at most its argument's change (d2 >= 0)
    # and rounds once on each side
    K_ring, t_ring, ev_ring = timed(lambda: ht.spatial.rbf(Xs, Xs, sigma=sigma, use_ring=True))
    ring_coll = timed.collectives
    ring_diff = comm.allreduce((K_ring.larray - K0.larray).abs().max() if counts[rank] else
                               torch.zeros((), device=dev), "max").item()
    x_max = comm.allreduce(Xs.larray.norm(dim=1).max() if counts[rank] else torch.zeros((), device=dev), "max").item()
    ring_bound = 2 * _gamma(F_MAIN + 2) * (2 * x_max) ** 2 / (2 * sigma**2) + 2 * F32_UNIT_ROUNDOFF
    check(ring_diff <= ring_bound, f"rbf use_ring vs the default route: {ring_diff} > {ring_bound}")
    if world > 1:
        check(ring_coll.get("ring_shift", {}).get("calls") == world - 1 and "allgather" not in ring_coll,
              f"the ring route should shift y's chunks {world - 1} times and gather nothing: {ring_coll}")
    del K_ring

    # replicated state bit-identical on every rank: the standardization, and a diagonal block's factor from the
    # same broadcast slab (what every rank computes once per panel inside cholesky)
    same_everywhere(mu.larray, "ridge mean")
    same_everywhere(sd.larray, "ridge std")
    b = min(MAX_FUSED_N, counts[0])
    blk = Kr[:b, :b].contiguous() if rank == 0 else torch.empty((b, b), dtype=Kr.dtype, device=dev)
    same_everywhere(cholesky_local(comm.bcast(blk, 0)), "a diagonal block's chol_panel_fused factor")
    # the same calls again, warm (every first call above carries cuBLAS' and cuSOLVER's set-up for its shapes)
    warm = {}
    for name, fn in (("rbf", lambda: ht.spatial.rbf(Xs, Xs, sigma=sigma)), ("+ eye", lambda: K0 + ht.eye(n, split=0)),
                     ("cholesky", lambda: ht.linalg.cholesky(K, tiles_per_proc=RIDGE_TILES)),
                     ("solve L", lambda: ht.linalg.solve_triangular(L, yv, lower=True)),
                     ("solve L.T", lambda: ht.linalg.solve_triangular(L.T, z1, lower=False))):
        _, host, ev = timed(fn)
        warm[name] = {"host_s": host, "event_ms": ev}
    say("ridge warm per call: " + "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events"
                                            for k, v in warm.items()))
    say(f"ridge ||L L^T - K||max/||K||max {recon:.3e} (gamma_(n+1) {_gamma(n + 1):.3e}), ||L L^T - K||_F "
        f"{dk_fro:.3e}; ||K alpha - y||/||y|| {resid:.3e}; rbf use_ring vs default max abs {ring_diff:.3e} (bound "
        f"{ring_bound:.3e}), ring rbf {t_ring:.4f} s host, {ev_ring:.4f} ms events, COLLECTIVES {ring_coll}")
    torch.save({"K": Kr.cpu(), "L": Lr.cpu()}, os.path.join(out_dir, f"ridge{rank}.pt"))
    summary = {"steps": steps, "warm": warm, "launches": launches, "stats": stats, "recon": recon, "dk_fro": dk_fro,
               "k_inf": k_inf, "resid": resid, "ring_diff": ring_diff, "ring_bound": ring_bound, "ring_host_s": t_ring,
               "ring_event_ms": ev_ring, "ring_collectives": ring_coll, "counts": counts, "bs": bs}
    return summary, (K, yv, alpha)


def _ridge_reference(ht, world, ranks, tmp):
    """The one-process factor of the ranks' K on this card, against the ranks' L: their difference within a
    bound derived from both factors' measured backward errors."""
    import torch

    dev = ht.get_device().torch_device
    n = N_RIDGE_CARD * world
    parts = [torch.load(os.path.join(tmp, f"ridge{r}.pt")) for r in range(world)]
    K = torch.cat([p["K"] for p in parts]).to(dev)
    Ls = [p["L"] for p in parts]
    del parts
    t_one = []
    for _ in range(2):  # the first call, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L0 = ht.linalg.cholesky(ht.array(K, copy=False)).larray
        torch.cuda.synchronize()
        t_one.append(time.perf_counter() - t0)
    L064 = L0.double()
    dk2_f2 = 0.0
    for r0 in range(0, n, 2048):
        d = L064[r0 : r0 + 2048] @ L064.T - K[r0 : r0 + 2048].double()
        dk2_f2 += (d * d).sum().item()
        del d
    dk2 = dk2_f2**0.5
    diff_f2, diff_max, r0 = 0.0, 0.0, 0
    for Lr in Ls:
        d = Lr.to(dev).double() - L064[r0 : r0 + Lr.shape[0]]
        diff_f2 += (d * d).sum().item()
        diff_max = max(diff_max, d.abs().max().item()) if d.numel() else diff_max
        r0 += Lr.shape[0]
        del d
    diff = diff_f2**0.5
    # Both factors are exact for K + dK_i (||dK_i||_F measured: dk1 across ranks, dk2 here). With
    # E = L0^-1 (dK_1 - dK_2) L0^-T, ||E||_F <= ||(K + dK_2)^-1||_2 ||dK_1 - dK_2||_F <= (dk1 + dk2) / (1 - dk2)
    # (lambda_min(K) >= 1), and L_1 = L0 chol(I + E), so to first order
    # ||L_1 - L0||_F <= ||L0||_2 ||E||_F / sqrt(2) with ||L0||_2^2 = ||K + dK_2||_2 <= ||K||_inf + dk2; a factor 2
    # covers the higher-order terms while ||E|| is small
    dk1, k_inf = ranks[0]["ridge"]["dk_fro"], ranks[0]["ridge"]["k_inf"]
    bound = 2 * (k_inf + dk2) ** 0.5 * (dk1 + dk2) / (2**0.5 * (1 - dk2))
    check(dk2 < 0.5 and diff <= bound, f"[dist] ridge L vs the one-process factor: ||dL||_F {diff} > bound {bound}")
    del K, L0, L064, Ls
    torch.cuda.empty_cache()
    return {"diff_fro": diff, "diff_max": diff_max, "bound": bound, "dk2": dk2, "t_one": t_one}


def _steps_line(steps):
    return "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, COLLECTIVES {v['collectives']}"
                     for k, v in steps.items())


def _dist_linalg(ht, world, rank, K, yv, alpha, timed, same_everywhere, say):
    """[dist]'s LU (solve on the ridge path's K, det and inv of a matrix with a known determinant), cg and
    lanczos on the row-split K, with their residuals computed across ranks; what the parent compares is
    returned (x and y whole, on rank 0)."""
    import torch

    comm = ht.get_comm()
    dev = ht.get_device().torch_device
    n = K.gshape[0]
    u = F32_UNIT_ROUNDOFF
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives}
        return out

    counts = [int(c) for c in K.lshape_map[:, 0]]
    starts = [sum(counts[:q]) for q in range(world)]
    k64, y_loc = K.larray.double(), yv.larray.double()
    y_norm = comm.allreduce((y_loc * y_loc).sum()).sqrt().item()

    def resid(x_full):  # ||K x - y|| across ranks, float64
        r = k64 @ x_full.double() - y_loc
        return comm.allreduce((r * r).sum()).sqrt().item()

    a_full = alpha._logical()
    r_a = resid(a_full)
    # solve against the Cholesky alpha: x - alpha = K^-1 (r_x - r_alpha), ||K^-1|| <= 1 (K = rbf + I)
    x = step("solve", lambda: ht.linalg.solve(K, yv))
    x_full = x._logical()
    r_x, dx = resid(x_full), (x_full.double() - a_full.double()).norm().item()
    check(x.split == (0 if world > 1 else None) and r_x / y_norm <= RIDGE_SOLVE_RTOL and dx <= (r_x + r_a) * (1 + 1e-6),
          f"[dist] solve: ||K x - y||/||y|| {r_x / y_norm}, ||x - alpha|| {dx} > {r_x + r_a}")
    bs = ht.factor_block_edge(K, 1, -(-n // world))
    panels = -(-n // bs)
    if world > 1:
        coll = steps["solve"]["collectives"]
        check(coll.get("bcast", {}).get("calls") == panels and coll.get("allgather", {}).get("calls", 0) <= 2 * panels,
              f"[dist] solve should run one panel allgather, at most one exchange allgather and one bcast per panel "
              f"({panels} panels): {coll}")
    # det and inv of Q diag(d) Q^T: det within n e^2 u of the float64 one (relative), ||A X - I||_max <= n u e^2
    a_full32, det64 = known_det_matrix(n, dev, DIST_LU_SEED)
    A = ht.DNDarray(a_full32[starts[rank] : starts[rank] + counts[rank]].contiguous(), gshape=(n, n), split=0)
    del a_full32
    d = step("det", lambda: ht.linalg.det(A))
    same_everywhere(d.larray.reshape(1), "det")
    e_det = abs(d.item() - det64) / abs(det64)
    check(math.isfinite(d.item()) and e_det <= n * math.e**2 * u, f"[dist] det {d.item()} vs {det64}: {e_det}")
    # a zero column makes a pivot exactly zero: its multipliers stay zero (the library's panel factorization on
    # the card included) and the determinant is an exact 0
    sing = torch.randn(16 * world, 16 * world, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    sing[:, 5] = 0.0
    d0 = ht.linalg.det(ht.DNDarray(sing[16 * rank : 16 * rank + 16].contiguous(), gshape=sing.shape, split=0)).item()
    check(d0 == 0.0, f"[dist] det of a matrix with a zero column is {d0}, not an exact 0")
    X = step("inv", lambda: ht.linalg.inv(A))
    check(X.split == 0 and X.gshape == (n, n), "[dist] inv metadata")
    # A X - I across ranks: X's row chunks rotate around the ring, block (r, q) = A_r[:, cols q] X_q in float64
    a64 = A.larray.double()
    acc = torch.zeros((counts[rank], n), dtype=torch.float64, device=dev)
    buf = torch.zeros((max(counts), n), dtype=X.larray.dtype, device=dev)
    buf[: counts[rank]] = X.larray
    for s_ in range(world):
        q = (rank + s_) % world
        if counts[q] and counts[rank]:
            acc += a64[:, starts[q] : starts[q] + counts[q]] @ buf[: counts[q]].double()
        if s_ < world - 1:
            buf = comm.ring_shift(buf)
    rows = torch.arange(counts[rank], device=dev)
    acc[rows, starts[rank] + rows] -= 1.0
    r_inv = comm.allreduce(acc.abs().max() if counts[rank] else torch.zeros((), dtype=torch.float64, device=dev),
                           "max").item()
    del acc, buf, a64, X
    check(r_inv <= n * u * math.e**2, f"[dist] ||A inv(A) - I||_max {r_inv} > {n * u * math.e**2}")
    # cg on K against alpha (the same bound as solve); lanczos on K: the largest Ritz pair's residual
    xc = step("cg", lambda: ht.linalg.cg(K, yv, ht.zeros(n, split=0)))
    xc_full = xc._logical()
    r_c, dxc = resid(xc_full), (xc_full.double() - a_full.double()).norm().item()
    check(r_c / y_norm <= RIDGE_SOLVE_RTOL and dxc <= (r_c + r_a) * (1 + 1e-6),
          f"[dist] cg: ||K x - y||/||y|| {r_c / y_norm}, ||x - alpha|| {dxc} > {r_c + r_a}")
    V, T = step("lanczos", lambda: ht.linalg.lanczos(K, N_LANCZOS))
    if world > 1:
        check(steps["lanczos"]["collectives"].get("allgather", {}).get("calls") == N_LANCZOS,
              f"[dist] lanczos should run one allgather per step: {steps['lanczos']['collectives']}")
    same_everywhere(V.larray, "lanczos V")
    same_everywhere(T.larray, "lanczos T")
    evals, evecs = torch.linalg.eigh(T.larray)
    r_top = ritz_residuals(K.larray, starts[rank], V.larray.double() @ evecs[:, -1:].double(), evals[-1:],
                           evals.abs().max(), comm)[0]
    check(r_top <= RITZ_RESID_RTOL, f"[dist] lanczos' largest Ritz pair: ||K v - theta v|| / ||K|| {r_top}")
    del V, T, k64
    warm = {}
    for name, fn in (("solve", lambda: ht.linalg.solve(K, yv)), ("det", lambda: ht.linalg.det(A)),
                     ("inv", lambda: ht.linalg.inv(A)), ("cg", lambda: ht.linalg.cg(K, yv, ht.zeros(n, split=0))),
                     ("lanczos", lambda: ht.linalg.lanczos(K, N_LANCZOS))):
        _, host, ev = timed(fn)
        warm[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives}
    say("lu/solvers warm per call: " + _steps_line(warm))
    say(f"lu/solvers n={n} (panels of {bs} rows): solve ||K x - y||/||y|| {r_x / y_norm:.3e}, ||x - alpha_cholesky|| "
        f"{dx:.3e} (<= {r_x + r_a:.3e}); det of Q diag(d) Q^T {d.item():.6e} vs float64 {det64:.6e} (relative "
        f"{e_det:.3e}, <= {n * math.e**2 * u:.3e}), of a {16 * world}-row matrix with a zero column {d0}; "
        f"||A inv(A) - I||_max {r_inv:.3e} (<= {n * u * math.e**2:.3e}); cg "
        f"||K x - y||/||y|| {r_c / y_norm:.3e}, ||x - alpha|| {dxc:.3e}; lanczos m={N_LANCZOS} largest Ritz value "
        f"{evals[-1].item():.6e}, residual {r_top:.3e}")
    say("lu/solvers per call: " + _steps_line(steps))
    y_full = yv._logical()  # a collective: every rank gathers, rank 0 keeps it
    return {"steps": steps, "warm": warm, "x": x_full.cpu() if rank == 0 else None,
            "y": y_full.cpu() if rank == 0 else None, "r_x": r_x, "panels": panels, "bs": bs}


def _normal_equations(a_l, b_l, comm):
    """float64 (A^T A, A^T b) of the row-split A and b, summed across ranks."""
    import torch

    gram = torch.zeros((a_l.shape[1], a_l.shape[1]), dtype=torch.float64, device=a_l.device)
    atb = torch.zeros(a_l.shape[1], dtype=torch.float64, device=a_l.device)
    for r0 in range(0, a_l.shape[0], 1 << 20):
        c = a_l[r0 : r0 + (1 << 20)].double()
        gram += c.T @ c
        atb += c.T @ b_l[r0 : r0 + (1 << 20)].double()
    return comm.allreduce(gram), comm.allreduce(atb)


def _lstsq_check(A, b, x, comm, what):
    """heat_tpu's lstsq keeps the QR route where min|diag R| > eps max(m, n) max|diag R| and otherwise returns
    pinv(A) b with the singular values at most eps max(m, n) s_1 cut. For Gaussian columns (cond ~1.004) that is
    the QR route while eps m < 1, and at eps m >= 1 every singular value is cut and x = 0 exactly. The QR route
    is held to [linalg]'s bound against the float64 normal equations (residual across ranks); returns
    (route, error, bound, cond)."""
    import torch

    m = A.gshape[0]
    gram, atb = _normal_equations(A.larray, b.larray, comm)
    s = torch.linalg.eigvalsh(gram).clamp(min=0).sqrt()
    kappa = (s.max() / s.min()).item()
    if torch.finfo(torch.float32).eps * max(m, F_SVD) >= 1.0:
        e_ls = x.larray.abs().max().item()
        check(e_ls == 0.0, f"[dist] {what} at eps m >= 1 should be heat_tpu's 0, not {x.larray}")
        return "pinv (every singular value cut: x = 0)", e_ls, 0.0, kappa
    x64 = torch.linalg.solve(gram, atb)
    r = b.larray.double() - A.larray.double() @ x64
    r_norm = comm.allreduce((r * r).sum()).sqrt().item()
    u = F32_UNIT_ROUNDOFF
    ls_bound = m**0.5 * u * (2 * kappa + kappa**2 * r_norm / (s.max().item() * x64.norm().item()))
    e_ls = ((x.larray.double() - x64).norm() / x64.norm()).item()
    check(e_ls <= ls_bound, f"[dist] {what} vs the float64 normal equations: {e_ls} > {ls_bound}")
    return "QR", e_ls, ls_bound, kappa


def _dist_svd(ht, world, rank, timed, same_everywhere, say):
    """[dist]'s svd and lstsq at N_SVD rows x F_SVD per card (TSQR above one card), residuals across ranks; and
    lstsq again at N_LSTSQ_CARD rows per card, where its QR route runs at up to four cards."""
    import torch

    comm = ht.get_comm()
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives}
        return out

    ht.random.seed(DIST_SVD_SEED)
    A = ht.random.randn(N_SVD * world, F_SVD, split=0)
    b = ht.random.randn(N_SVD * world, split=0)
    U, S, Vh = step("svd", lambda: ht.linalg.svd(A))
    check(U.split == 0 and S.split is None and Vh.split is None, "[dist] svd metadata")
    same_everywhere(S.larray, "svd S")
    same_everywhere(Vh.larray, "svd Vh")
    a_l, us = A.larray, (U.larray * S.larray).double()
    e2, a2 = torch.zeros((), dtype=torch.float64, device=a_l.device), torch.zeros((), dtype=torch.float64, device=a_l.device)
    for r0 in range(0, a_l.shape[0], 1 << 20):
        c = a_l[r0 : r0 + (1 << 20)].double()
        e2 += ((us[r0 : r0 + (1 << 20)] @ Vh.larray.double() - c) ** 2).sum()
        a2 += (c * c).sum()
    del us
    e_rec = (comm.allreduce(e2) / comm.allreduce(a2)).sqrt().item()
    check(e_rec <= SVD_RESID_RTOL, f"[dist] svd ||A - U S Vh||_F/||A||_F {e_rec}")
    x = step("lstsq", lambda: ht.linalg.lstsq(A, b))
    check(x.split is None, "[dist] lstsq result replicated")
    same_everywhere(x.larray, "lstsq x")
    route, e_ls, ls_bound, kappa = _lstsq_check(A, b, x, comm, "lstsq")
    shape, rows = A.gshape, A.lshape_map[:, 0].tolist()
    del A, b, U
    # the QR route across ranks (TSQR's R, Q^T b across ranks, the triangular solve) at eps m < 1, on
    # b = A w + 1e-3 noise as [linalg]'s: a small residual keeps the bound's kappa^2 ||r|| term small
    A2 = ht.random.randn(N_LSTSQ_CARD * world, F_SVD, split=0)
    b2 = ht.matmul(A2, ht.random.randn(F_SVD)) + 1e-3 * ht.random.randn(N_LSTSQ_CARD * world, split=0)
    x2 = step("lstsq (QR route)", lambda: ht.linalg.lstsq(A2, b2))
    check(x2.split is None, "[dist] lstsq (QR route) result replicated")
    same_everywhere(x2.larray, "lstsq (QR route) x")
    route2, e_ls2, ls_bound2, kappa2 = _lstsq_check(A2, b2, x2, comm, "lstsq (QR route)")
    check(route2 == "QR", f"[dist] lstsq at {N_LSTSQ_CARD * world} rows took the {route2} route")
    say(f"svd/lstsq {shape} split 0 (lshape_map {rows} rows): ||A - U S Vh||_F/||A||_F {e_rec:.3e}; lstsq route {route}, vs float64 {e_ls:.3e} (<= "
        f"{ls_bound:.3e}), cond {kappa:.4f}; lstsq at {(N_LSTSQ_CARD * world, F_SVD)}: route {route2}, vs float64 "
        f"{e_ls2:.3e} (<= {ls_bound2:.3e}), cond {kappa2:.4f}; per call: {_steps_line(steps)}")
    return {"steps": steps, "S": S.larray.cpu(), "x": x.larray.cpu(), "ls_bound": ls_bound, "route": route,
            "qr_route": {"e": e_ls2, "bound": ls_bound2}}


def _dist_spectral(ht, world, rank, timed, same_everywhere, say):
    """[dist]'s spectral path on [spectral]'s global data (N_SPEC rows split over the ranks)."""
    import torch

    comm = ht.get_comm()
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives}
        return out

    member, x = step("draws", lambda: spectral_data(ht))
    z = step("standardize", lambda: (x - ht.mean(x, axis=0)) / ht.std(x, axis=0))
    sp = step("fit", lambda: spectral_fit(ht, z))
    pred = step("predict", lambda: sp.predict(z))
    evals, V, evecs = step("embedding (Ritz values)", lambda: sp._spectral_embedding(z))
    check(sp.labels_.split == 0 and pred.split == 0 and torch.equal(pred.larray, sp.labels_.larray),
          "[dist] spectral predict == labels_, split 0")
    acc, _ = matched_labels(sp.labels_.larray, member.larray, K_SPEC, comm, "[dist] labels vs the blobs")
    check(acc >= SPEC_ACC, f"[dist] spectral labels agree with the blobs on {acc}")
    same_everywhere(evals, "spectral Ritz values")
    same_everywhere(sp._cluster.cluster_centers_.larray, "spectral centers")
    say(f"spectral {x.gshape} (lshape_map {x.lshape_map[:, 0].tolist()} rows): labels agree with the blobs on "
        f"{acc:.6f}; per call: {_steps_line(steps)}")
    Y = V.double() @ evecs[:, :K_SPEC].double()  # the k smallest Ritz vectors, replicated
    return {"steps": steps, "labels": sp.labels_.larray.to(torch.int8).cpu(), "evals": evals.cpu(), "Y": Y.cpu()}


def _digest(t):
    """Two int64 sums over the bit patterns of a float32 or int64 tensor (the second weighted by position):
    equal digests of two chunks mean, short of a collision, equal bits."""
    import torch

    b = (t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t.contiguous()).reshape(-1).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return [int(b.sum()), int((b * w).sum())]


def _robust_writes(zz, z, world):
    """[dist]'s cross-rank writes into zz: L = min(4096 P, n / P) rows from n/P - 1000 (P = max(world, 2): across
    the first rank boundary) get rows from 10 on, a split value rebalanced from another offset; then every
    (n / (2 world) + 3)-th row from row 5 (rows on every rank) gets a replicated value."""
    n, p = zz.gshape[0], max(world, 2)
    lo, length = n // p - 1000, min(4096 * p, n // p)
    zz[lo : lo + length] = z[10 : 10 + length]
    rows = slice(5, n, n // (2 * world) + 3)
    zz[rows] = z[: len(range(*rows.indices(n)))].resplit(None) * 2.0


def _dist_robust(ht, world, rank, timed, same_everywhere, say):
    """[dist]'s robust steps on [robust]'s data at N_ROBUST rows per card (weak scaling): concatenate, the split-axis
    percentiles and median (the key-bisection selection), the clip, a cross-rank __setitem__ with a split value, the split-axis
    sort of one feature (sample sort: bytes received per rank at most 3x its share of values and indices),
    reshape to one flat axis and back, KMedians from one row of each blob, unique of its labels, topk of the
    largest L1 distances. What the parent holds against one process: replicated results whole, chunks digested."""
    import torch

    comm = ht.get_comm()
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives, "received": timed.received}
        return out

    member, x = step("draws + concatenate", lambda: robust_data(ht, world))
    n = x.gshape[0]
    pct = step("percentile", lambda: ht.percentile(x, list(ROBUST_Q), axis=0))
    med = step("median", lambda: ht.median(x, axis=0))

    def scale_clip():
        z = (x - med) / (pct[2] - pct[0])
        z[ht.abs(z) > ROBUST_CLIP] = ROBUST_CLIP
        return z

    z = step("scale + clip", scale_clip)
    out = {"x": _digest(x.larray), "z": _digest(z.larray), "pct": pct.larray.cpu(), "med": med.larray.cpu()}
    del x
    torch.cuda.empty_cache()
    col = z[:, 1]
    (sv, si) = step("sort", lambda: ht.sort(col))
    share = comm.chunk(col.gshape, 0)[1][0] * (4 + 8)
    recv = sum(steps["sort"]["received"].values())
    check(recv <= 3 * share, f"[dist] sort: rank {rank} received {recv} B, more than 3x its share {share} B")
    check(bool((sv.larray[1:] >= sv.larray[:-1]).all()), "[dist] sort: a chunk is not ascending")
    out.update(sort_values=_digest(sv.larray), sort_indices=_digest(si.larray), sort_received=recv, sort_share=share)
    del col, sv, si
    flat = step("reshape", lambda: ht.reshape(z, (z.size,)))
    back = ht.reshape(flat, z.gshape)
    check(flat.split == 0 and torch.equal(back.larray, z.larray), "[dist] reshape to one axis and back")
    del flat, back
    zz = z.copy()
    step("setitem", lambda: _robust_writes(zz, z, world))
    out["setitem"] = _digest(zz.larray)
    del zz
    init = z[first_rows(member, K_ROBUST)]
    km = step("KMedians fit", lambda: ht.cluster.KMedians(K_ROBUST, init=init, max_iter=ROBUST_ITERS, tol=None).fit(z))
    same_everywhere(km.cluster_centers_.larray, "KMedians centres")
    uq = step("unique", lambda: ht.unique(km.labels_))
    assigned = ht.DNDarray(km.cluster_centers_.larray[km.labels_.larray], gshape=z.gshape, split=0)
    d = ht.sum(ht.abs(z - assigned), axis=1)
    tv, ti = step("topk", lambda: ht.topk(d, N_TOPK))
    out.update(centres=km.cluster_centers_.larray.cpu(), n_iter=km.n_iter_, labels=_digest(km.labels_.larray),
               unique=uq._logical().cpu(), topk_values=tv._logical().cpu(), topk_indices=ti._logical().cpu(), steps=steps)
    say("robust per call: " + _steps_line(steps) + f"; sort received {recv} B, {recv / share:.3f} of the rank's "
        f"share of values and indices ({share} B)")
    del z, d, assigned, km
    torch.cuda.empty_cache()
    return out


def _robust_reference(ht, world, ranks):
    """[dist]'s robust steps in this process on one card, on the same global data, held against the ranks:
    percentiles, median and KMedians centres equal, every chunk's digest equal (x, z, the sort's values and
    indices, the cross-rank write, the labels), unique and topk equal. Returns the one-card times."""
    import torch

    t = {}

    def first(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out

    member, x = first("draws + concatenate", lambda: robust_data(ht, world))
    n = x.gshape[0]
    rows = _ceil_div_map((n,), 0, world)[:, 0].tolist()  # the ranks' chunks
    starts = [sum(rows[:r]) for r in range(world)]

    def chunks_digest(t_):
        return [_digest(t_[s : s + c]) for s, c in zip(starts, rows)]

    check([r["robust"]["x"] for r in ranks] == chunks_digest(x.larray), "[dist] concatenate: x differs from one process")
    pct = first("percentile", lambda: ht.percentile(x, list(ROBUST_Q), axis=0)).larray
    med = first("median", lambda: ht.median(x, axis=0)).larray
    # above one card the median along the split axis is heat_tpu's 50th percentile (linear rule): its value at
    # the middle ranks equals jnp.median's midpoint up to one rounding; the ranks must equal the percentile's row
    for r in ranks:
        check(torch.equal(r["robust"]["pct"].to(pct.device), pct), "[dist] percentiles differ from one process")
        want_med = pct[1] if world > 1 else med
        check(torch.equal(r["robust"]["med"].to(pct.device), want_med), "[dist] median differs from one process")
    z = (x - ht.array(ranks[0]["robust"]["med"].to(pct.device))) / ht.array((pct[2] - pct[0]))
    z[ht.abs(z) > ROBUST_CLIP] = ROBUST_CLIP
    del x
    torch.cuda.empty_cache()
    check([r["robust"]["z"] for r in ranks] == chunks_digest(z.larray), "[dist] z differs from one process")
    sv, si = first("sort", lambda: ht.sort(z[:, 1]))
    check([r["robust"]["sort_values"] for r in ranks] == chunks_digest(sv.larray)
          and [r["robust"]["sort_indices"] for r in ranks] == chunks_digest(si.larray),
          "[dist] sort values or indices differ from one process")
    del sv, si
    zz = z.copy()
    _robust_writes(zz, z, world)
    check([r["robust"]["setitem"] for r in ranks] == chunks_digest(zz.larray),
          "[dist] the cross-rank write differs from one process")
    del zz
    init = z[first_rows(member, K_ROBUST)]
    km = first("KMedians fit", lambda: ht.cluster.KMedians(K_ROBUST, init=init, max_iter=ROBUST_ITERS, tol=None).fit(z))
    check(torch.equal(ranks[0]["robust"]["centres"].to(z.larray.device), km.cluster_centers_.larray),
          "[dist] KMedians centres differ from one process")
    check([r["robust"]["labels"] for r in ranks] == chunks_digest(km.labels_.larray), "[dist] KMedians labels")
    uq = ht.unique(km.labels_).numpy()
    assigned = ht.DNDarray(km.cluster_centers_.larray[km.labels_.larray], gshape=z.gshape, split=0)
    tv, ti = ht.topk(ht.sum(ht.abs(z - assigned), axis=1), N_TOPK)
    import numpy as np

    check(np.array_equal(ranks[0]["robust"]["unique"].numpy(), uq), "[dist] unique labels differ from one process")
    # the distances are row sums over 32 features, which torch may add in another order for a chunk than for the
    # whole array: the values within 32 roundings (32 u relative), the rows the same (the top values lie far apart)
    tv_h, ti_h = tv.numpy(), ti.numpy()
    check(np.allclose(ranks[0]["robust"]["topk_values"].numpy(), tv_h, rtol=32 * F32_UNIT_ROUNDOFF, atol=0)
          and set(ranks[0]["robust"]["topk_indices"].tolist()) == set(ti_h.tolist()), "[dist] topk differs from one process")
    del z, km, assigned, tv, ti
    torch.cuda.empty_cache()
    return t


def _linalg_reference(ht, world, ranks, tmp):
    """The one-process port on one card against the ranks: solve of the same K (torch.linalg.solve at world size
    1), svd and lstsq of the same A, the spectral path on the same data; times of each."""
    import torch

    dev = ht.get_device().torch_device
    out = {}
    K = torch.cat([torch.load(os.path.join(tmp, f"ridge{r}.pt"))["K"] for r in range(world)]).to(dev)
    y, x_d = ranks[0]["lu"]["y"].to(dev), ranks[0]["lu"]["x"].to(dev)
    t = []
    for _ in range(2):  # the first call, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x1 = ht.linalg.solve(ht.array(K, copy=False), ht.array(y, copy=False)).larray
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    r1 = (K.double() @ x1.double() - y.double()).norm().item()
    d = (x1.double() - x_d.double()).norm().item()
    # both solutions against the same K: ||x_1 - x_d|| <= ||r_1|| + ||r_d|| (||K^-1|| <= 1)
    check(d <= (r1 + ranks[0]["lu"]["r_x"]) * (1 + 1e-6), f"[dist] solve vs one card's: {d}")
    out["solve"] = {"t": t, "diff": d, "r1": r1}
    del K
    torch.cuda.empty_cache()
    ht.random.seed(DIST_SVD_SEED)
    A = ht.random.randn(N_SVD * world, F_SVD, split=0)
    b = ht.random.randn(N_SVD * world, split=0)
    t = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s1 = ht.linalg.svd(A, compute_uv=False).larray
        x1 = ht.linalg.lstsq(A, b).larray
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    # two SVDs of A, each exact for A + dA with ||dA|| ~ sqrt(m) u ||A|| (inner products over m rows, random signs):
    # their singular values within 2 sqrt(m) u s_1 (Weyl)
    e_s = (s1 - ranks[0]["svd"]["S"].to(dev)).abs().max().item()
    s_bound = 2 * (N_SVD * world) ** 0.5 * F32_UNIT_ROUNDOFF * s1.max().item()
    e_x = (x1.double() - ranks[0]["svd"]["x"].to(dev).double()).norm().item()
    check(e_s <= s_bound and e_x <= 2 * ranks[0]["svd"]["ls_bound"] * x1.double().norm().item(),
          f"[dist] svd/lstsq vs one process: S {e_s} (bound {s_bound}), ||x - x_one|| {e_x}")
    out["svd"] = {"t": t, "e_s": e_s, "s_bound": s_bound, "e_x": e_x}
    del A, b
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    member, x = spectral_data(ht)
    z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
    sp = spectral_fit(ht, z)
    torch.cuda.synchronize()
    t_sp = time.perf_counter() - t0
    evals = sp._spectral_embedding(z)[0]
    labels = torch.cat([r["spectral"]["labels"] for r in ranks]).to(dev)
    same, _ = matched_labels(labels, sp.labels_.larray, K_SPEC, what="[dist] spectral labels vs one card's")
    check(same == 1.0, f"[dist] spectral labels equal one card's up to a permutation on only {same}")
    evals_d = ranks[0]["spectral"]["evals"].to(dev)
    e_ritz = (evals_d[:K_SPEC] - evals[:K_SPEC]).abs().max().item()
    check(e_ritz <= RITZ_ATOL, f"[dist] Ritz values vs one card's: {e_ritz}")
    # the ranks' k smallest Ritz pairs (from their z and their row-split L) against this process's L
    L1 = sp._laplacian.construct(z)
    resid_x = ritz_residuals(L1.larray, 0, ranks[0]["spectral"]["Y"].to(dev), evals_d[:K_SPEC], evals_d.abs().max())
    del L1
    check(max(resid_x) <= RITZ_RESID_RTOL, f"[dist] the ranks' Ritz pairs against one card's L: {resid_x}")
    out["spectral"] = {"t": t_sp, "e_ritz": e_ritz, "resid_x": resid_x}
    return out


DT_DIST_SEED = 23
N_DIST_CX = 1 << 24  # complex samples per card for vdot and the lexicographic max
N_DIST_U8 = 1 << 22  # uint8 rows (x F_DT) per card for the exact sum


def _dist_dtypes(ht, world, rank, timed, same_everywhere, say):
    """[dist]'s steps over the new types: ``convolve`` of N_CONV samples per card over the split-axis halos (each
    rank sends and receives at most two halos of M_CONV // 2 rows; ``full`` and ``valid`` add the one alltoall that
    rebalances the longer or shorter result), each mode against one card's ``convolve`` of the whole signal
    (computed on this rank's card) within 2 M u sum|a||v|; the complex ``vdot`` (one allreduce of one complex
    scalar) and lexicographic ``max``; the uint8 ``sum``, exact; and the halos of an array whose last rank is empty
    at four cards, against the rows they must hold."""
    import numpy as np
    import torch

    comm = ht.get_comm()
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives, "received": timed.received}
        return out

    halo_bytes = 2 * (M_CONV // 2) * 4  # two halos of M // 2 float32 rows
    ht.random.seed(DT_DIST_SEED)
    a = ht.random.randn(N_CONV * world, split=0)
    v = ht.array(windowed_sinc(M_CONV, CONV_CUTOFF))
    mine = {mode: step(f"convolve {mode}", lambda mode=mode: ht.convolve(a, v, mode)) for mode in ("full", "same",
                                                                                                   "valid")}
    for mode in mine:
        step(f"warm convolve {mode}", lambda mode=mode: ht.convolve(a, v, mode))
    for mode, r in mine.items():
        coll, recv = steps[f"convolve {mode}"]["collectives"], steps[f"convolve {mode}"]["received"]
        want = set() if world == 1 else {"halo"} if mode == "same" else {"halo", "alltoall"}
        check(set(coll) == want, f"[dist] convolve {mode} ran {coll}, expected {sorted(want)}")
        if world > 1:
            check(coll["halo"]["calls"] == 1 and coll["halo"]["bytes"] <= halo_bytes
                  and recv["halo"] <= halo_bytes, f"[dist] convolve {mode} halos: {coll['halo']}, received {recv}")
            if "alltoall" in coll:
                check(coll["alltoall"]["calls"] == 1, f"[dist] convolve {mode} rebalance: {coll['alltoall']}")
        check(np.array_equal(r.lshape_map, _ceil_div_map(r.gshape, 0, world)), f"[dist] convolve {mode} layout")
    # one card's convolve of the whole signal, on this rank's card
    ht.random.seed(DT_DIST_SEED)
    whole = ht.random.randn(N_CONV * world)
    check(torch.equal(whole.larray[comm.chunk(whole.gshape, 0)[2]], a.larray), "[dist] the signal is not split-invariant")
    worst = {}
    for mode, r in mine.items():
        for name in (f"one card convolve {mode}", f"warm one card convolve {mode}"):
            ref, t_one, ev_one = timed(lambda mode=mode: ht.convolve(whole, v, mode))
            steps[name] = {"host_s": t_one, "event_ms": ev_one, "collectives": {}, "received": {}}
        sl = comm.chunk(ref.gshape, 0)[2]
        mags = ht.convolve(ht.abs(whole), ht.abs(v), mode).larray[sl].double()
        bound = 2 * M_CONV * F32_UNIT_ROUNDOFF * mags  # both results within M u sum|a||v| of the exact value
        e = (r.larray.double() - ref.larray[sl].double()).abs()
        check(bool((e <= bound).all()), f"[dist] convolve {mode} vs one card: worst {(e / bound).max().item():.3f}")
        worst[mode] = (e / bound).max().item() if e.numel() else 0.0
        del ref, mags, e
    del a, whole, mine
    torch.cuda.empty_cache()

    # complex vdot and lexicographic max across cards
    ht.random.seed(DT_DIST_SEED + 1)
    sig = ht.random.randn(N_DIST_CX * world, split=0) + ht.random.randn(N_DIST_CX * world, split=0) * 1j
    check(sig.dtype is ht.complex64 and sig.split == 0, f"[dist] the complex signal is {sig.dtype}")
    vd = step("vdot(s, s)", lambda: ht.vdot(sig, sig))
    coll = steps["vdot(s, s)"]["collectives"]
    check(coll == ({} if world == 1 else {"allreduce": {"calls": 1, "bytes": 8}}),
          f"[dist] vdot should run one allreduce of one complex64 scalar: {coll}")
    mx = step("max (lexicographic)", lambda: ht.max(sig))
    same_everywhere(torch.view_as_real(vd.larray.reshape(1)), "vdot")
    same_everywhere(torch.view_as_real(mx.larray.reshape(1)), "complex max")
    full_sig = sig.resplit(None)
    p2 = full_sig.larray.abs().double() ** 2
    v_ref = p2.sum().item()
    v_bound = (SUM_LAMBDA * math.sqrt(N_DIST_CX * world) + 3) * F32_UNIT_ROUNDOFF * v_ref
    e_vd = abs(complex(vd.item()) - v_ref)
    check(e_vd <= v_bound, f"[dist] vdot {vd.item()} vs {v_ref}: {e_vd} > {v_bound}")
    check(complex(mx.item()) == complex(ht.max(full_sig).item()), "[dist] lexicographic max vs one card")
    del sig, full_sig, p2

    # uint8 sum, exact
    ht.random.seed(DT_DIST_SEED + 2)
    u8 = ht.random.randint(0, 256, size=(N_DIST_U8 * world, F_DT), split=0, dtype=ht.uint8)
    su = step("sum(uint8, axis=0)", lambda: ht.sum(u8, axis=0))
    check(su.dtype is ht.int64 and torch.equal(su.larray, u8.resplit(None).larray.sum(dim=0)),
          "[dist] uint8 sum vs one card")
    del u8

    # halos where the last rank holds nothing (at four cards: 9 rows in chunks of 3, 3, 3, 0), and a convolve there
    n_small, hs = 3 * max(world - 1, 1), 2
    small = ht.arange(n_small * 2, dtype=ht.float32, split=0).reshape((n_small, 2))
    step("get_halo(2)", lambda: small.get_halo(hs))
    counts, displs = small.counts_displs()

    def carries(b):
        return 0 < b < world and counts[b - 1] >= hs and counts[b] >= hs

    rows = torch.arange(n_small * 2, dtype=torch.float32, device=small.larray.device).reshape(n_small, 2)
    want_prev = rows[displs[rank] - hs:displs[rank]] if carries(rank) else None
    want_next = rows[displs[rank + 1]:displs[rank + 1] + hs] if carries(rank + 1) else None
    for got, want, what in ((small.halo_prev, want_prev, "halo_prev"), (small.halo_next, want_next, "halo_next")):
        check((got is None) == (want is None) and (got is None or torch.equal(got, want)),
              f"[dist] rank {rank} {what} {got} vs {want}")
    if world == 4:
        check(counts == (3, 3, 3, 0) and (rank != 3 or small.halo_prev is None and small.halo_next is None),
              f"[dist] the last rank should be empty and get no halo: counts {counts}")
    cs = ht.convolve(small[:, 0], ht.array(np.array([1.0, -2.0, 1.0], np.float32)), "full")
    check(np.array_equal(cs.numpy(), np.convolve(np.arange(0, 2 * n_small, 2), [1, -2, 1]).astype(np.float32)),
          "[dist] convolve over an empty last rank")
    say("dtypes: " + _steps_line(steps) + f"; convolve vs one card, worst share of 2 M u sum|a||v|: "
        + ", ".join(f"{k} {w:.3f}" for k, w in worst.items()) + f"; halo counts {counts}")
    return {"steps": steps, "worst": worst, "vdot": complex(vd.item()), "vdot_err": e_vd, "vdot_bound": v_bound}


DIST_STREAM_SEED = 24


def _stream_dist_data(ht):
    """[dist]'s stream data: [main]'s blob recipe at N_MAIN rows in all (strong scaling), drawn split 0 with the
    port's split-invariant stream, so one process draws the same global array; row c of the first K_MAIN in blob c."""
    import torch

    ht.random.seed(DIST_STREAM_SEED)
    true = ht.random.randn(K_MAIN, F_MAIN) * 8.0
    member = ht.random.randint(0, K_MAIN, size=(N_MAIN,), split=0, dtype=ht.int64)
    off = member.comm.chunk(member.gshape, 0)[0]
    if off < K_MAIN:
        member.larray[: K_MAIN - off] = torch.arange(off, K_MAIN, device=member.larray.device)
    return ht.random.randn(N_MAIN, F_MAIN, split=0) + ht.DNDarray(true.larray[member.larray], gshape=(N_MAIN, F_MAIN),
                                                                  split=0)


def _dist_stream(ht, world, rank, timed, same_everywhere, say, out_dir):
    """[dist]'s stream steps on N_MAIN x F_MAIN blobs in all: a save from every rank (each writes its rows into the
    one file, in rank order), a split-0 load (each reads only its rows: the reader's row windows are recorded),
    ``StreamingMoments`` and ``StreamingKMeans`` (STREAM_EPOCHS epochs) over a split-0 ``ChunkIterator`` of the file,
    gated on their collectives (two ``allreduce`` per chunk for the moments, one per chunk and epoch for the fit),
    and ``merge_processes`` of per-rank moments through ``tree_merge`` (log2 P rounds, bit-identical on every
    rank). Returns what the parent holds against one process."""
    import torch

    from heat_tpu_torch.core import _netcdf3

    comm = ht.get_comm()
    steps = {}

    def step(name, fn):
        out, host, ev = timed(fn)
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives}
        return out

    x = _stream_dist_data(ht)
    path = os.path.join(out_dir, "stream_x.nc")
    step("save", lambda: ht.save(x, path, "x", format="NETCDF3_64BIT"))
    reads, real_read = [], _netcdf3.NetCDF3File.read

    def spy(self, variable, start=0, stop=None):
        reads.append((start, stop))
        return real_read(self, variable, start, stop)

    _netcdf3.NetCDF3File.read = spy
    try:
        y = step("load", lambda: ht.load(path, "x", split=0))
    finally:
        _netcdf3.NetCDF3File.read = real_read
    off, lsh, _ = comm.chunk(x.gshape, 0)
    check(reads == [(off, off + lsh[0])], f"[dist] stream: rank {rank} read rows {reads}, not its [{off}, "
                                          f"{off + lsh[0]})")
    check(y.gshape == x.gshape and torch.equal(y.larray, x.larray), "[dist] stream: the load differs from the save")
    digest = _digest(y.larray)
    del y
    it = ht.stream.ChunkIterator(path, STREAM_CHUNK, dataset="x")
    n_chunks = len(it)
    ht.kernels.reset_kernel_stats()

    def moments():
        m = ht.stream.StreamingMoments()
        for c in ht.stream.Prefetcher(it, depth=STREAM_DEPTH):
            m.update(c)
        return m

    sm = step("StreamingMoments pass", moments)
    calls = {k: v["calls"] for k, v in steps["StreamingMoments pass"]["collectives"].items()}
    want = {"allreduce": 2 * n_chunks} if world > 1 else {}  # a chunk of one rank is not split across ranks
    check(calls == want, f"[dist] stream: the moments pass ran {calls}, not moments_sharded's {want}")
    check(ht.LAUNCHES["moments_onepass"] == n_chunks, f"[dist] stream: moments launches {dict(ht.LAUNCHES)}")
    init = x[:K_MAIN].resplit(None)
    ht.kernels.reset_kernel_stats()
    fit = step("StreamingKMeans fit", lambda: ht.cluster.StreamingKMeans(
        K_MAIN, init=init, max_iter=STREAM_EPOCHS, tol=None).fit(it, prefetch_depth=STREAM_DEPTH))
    calls = {k: v["calls"] for k, v in steps["StreamingKMeans fit"]["collectives"].items()}
    want = {"allreduce": n_chunks * STREAM_EPOCHS}  # lloyd_sharded sums over the group at any size, as KMeans'
    check(calls == want, f"[dist] stream: the fit ran {calls}, not one allreduce per chunk and epoch {want}")
    check(ht.LAUNCHES["lloyd_fused"] == n_chunks * STREAM_EPOCHS, f"[dist] stream: lloyd launches {dict(ht.LAUNCHES)}")
    for name, t in (("streamed mean", sm.mean.larray), ("streamed var", sm.var.larray),
                    ("streamed centres", fit.cluster_centers_.larray)):
        same_everywhere(t, name)
    # per-rank moments of this rank's own rows, merged across the ranks
    mine = ht.stream.StreamingMoments()
    part = max(1, STREAM_CHUNK // world)
    for a in range(0, lsh[0], part):
        mine.update(ht.DNDarray(x.larray[a:a + part], comm=ht.SELF))
    step("merge_processes", mine.merge_processes)
    calls = {k: v["calls"] for k, v in steps["merge_processes"]["collectives"].items()}
    rounds = ht.tree_merge_rounds(world)
    check(calls == ({"tree_merge": rounds} if world > 1 else {}),
          f"[dist] stream: merge_processes ran {calls}, not {rounds} tree_merge rounds")
    same_everywhere(mine.mean.larray, "merged mean")
    same_everywhere(mine.var.larray, "merged var")
    say("stream: " + "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, COLLECTIVES "
                               f"{v['collectives']}" for k, v in steps.items()))
    out = {"digest": digest, "rows": (off, lsh[0]), "mean": sm.mean.larray.cpu(), "var": sm.var.larray.cpu(),
           "centers": fit.cluster_centers_.larray.cpu(), "merged_mean": mine.mean.larray.cpu(),
           "merged_var": mine.var.larray.cpu(), "steps": steps, "rounds": rounds, "chunks": n_chunks}
    del x, sm, fit, mine, it, init
    torch.cuda.empty_cache()
    return out


def _stream_reference(ht, world, ranks, tmp):
    """One process on [dist]'s stream data and the file the ranks saved: the file loads equal to the draw, each
    rank's chunk digested as the rank digested it; one card's streamed moments (timed: the strong-scaling baseline)
    and in-memory moments and KMeans against the ranks' within the merge and accumulation bounds."""
    import torch

    ht.use_device("gpu")
    x = _stream_dist_data(ht)
    path = os.path.join(tmp, "stream_x.nc")
    y = ht.load(path, "x", split=0)
    check(torch.equal(y.larray, x.larray), f"[dist] stream: the file {world} rank(s) saved differs from the draw")
    for r in ranks:
        off, n = r["stream"]["rows"]
        check(_digest(y.larray[off:off + n]) == r["stream"]["digest"], f"[dist] stream: rank {r['rank']}'s chunk digest")
    del y
    it = ht.stream.ChunkIterator(path, STREAM_CHUNK, dataset="x")
    t0 = time.perf_counter()
    sm1 = ht.stream.StreamingMoments()
    for c in ht.stream.Prefetcher(it, depth=STREAM_DEPTH):
        sm1.update(c)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    var64 = x.larray.double().var(dim=0, unbiased=False)
    mu64 = x.larray.double().mean(dim=0)
    mb, vb = merge_bounds(x.larray, STREAM_CHUNK // max(world, 1), var64)  # the ranks' finer chunks: more merges
    mb1, vb1 = merge_bounds(x.larray, STREAM_CHUNK, var64)
    st = ranks[0]["stream"]
    worst = 0.0
    for name, got, ref, bound in (("mean", st["mean"], mu64, mb + mb1), ("var", st["var"], var64, vb + vb1),
                                  ("one card mean", sm1.mean.larray, mu64, mb1), ("one card var", sm1.var.larray,
                                                                                   var64, vb1),
                                  ("merged mean", st["merged_mean"], mu64, mb), ("merged var", st["merged_var"], var64,
                                                                                 vb)):
        e = (got.to(x.larray.device).double() - ref).abs()
        check(bool((e <= bound).all()), f"[dist] stream {name} vs float64: {(e / bound).max().item():.3f} of the bound")
        worst = max(worst, (e / bound).max().item())
    km = ht.cluster.KMeans(K_MAIN, init=x[:K_MAIN], max_iter=STREAM_EPOCHS, tol=None).fit(x)
    onehot = torch.nn.functional.one_hot(km.labels_.larray.long(), K_MAIN).to(torch.float32)
    abs_sums = (onehot.T @ x.larray.abs()).double()
    counts = onehot.sum(dim=0).double()
    c_ref = km.cluster_centers_.larray.double()
    c_bound = (2 * SUM_LAMBDA * torch.sqrt(counts)[:, None] * F32_UNIT_ROUNDOFF * abs_sums / counts[:, None]
               + 2 * F32_UNIT_ROUNDOFF * c_ref.abs())
    e_c = (st["centers"].to(x.larray.device).double() - c_ref).abs()
    check(bool((e_c <= c_bound).all()), f"[dist] stream centres vs one card's KMeans: {(e_c / c_bound).max().item():.3f}")
    del x, onehot, km
    torch.cuda.empty_cache()
    return {"t_one_pass": t_one, "worst": worst, "centres": (e_c / c_bound).max().item()}


def _dist_layout(ht, world, rank, timed, same_everywhere, say, seed):
    """The slice's path across ranks, at N_MAIN rows per card of [main]'s blobs (numpy from ``seed``), twice: with
    the skewed map (0.40, 0.30, 0.20, 0.10) and with the empty-shard map (0.50, 0.25, 0.25, 0) (their analogues at
    other world sizes, see ``layout_shares``): ``redistribute_`` (one move), standardize in place (no move,
    ``moments_onepass`` on the rank's ragged rows), ``z + y`` with y in the head-skewed layout (one move, z's
    layout kept), ``cumsum``/``nonzero``/``sum``/``max``/``copy``/``astype`` (nothing moves), ``KMeans.fit`` (one
    rebalance, 31 ``lloyd_fused``). Each step is gated on its (rebalances, moves), each move on the bytes the rank
    received (exactly the rows it lacked); the standardized data, labels and centres are held against the same
    steps on the ceil-div layout. Beside the path: ring and Ulysses attention (H, N, D) = (8, N_ATT_CARD x world,
    128), full and causal, N divisible and not, against each other and float64; ``halo_exchange`` (halo 2),
    ``ring_map`` of squared distances against ``cdist(use_ring=True)``, ``ring_reduce`` of the row minima, and a
    ``bucket_move`` of N_MAIN rows a rank by a skewed matrix."""
    import numpy as np
    import torch

    from heat_tpu_torch.core.kernels import RECEIVED
    from heat_tpu_torch.parallel import flatmove
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    comm = ht.get_comm()
    dev = ht.get_device().torch_device
    seed = seed + LAYOUT_SEED_OFFSET
    n, row_bytes = N_MAIN * world, F_MAIN * 4
    canon = list(comm.counts_displs_shape((n, F_MAIN), 0)[0])
    lo = sum(canon[:rank])
    x_np = layout_blobs(seed, n, lo, lo + canon[rank])
    steps, moves = {}, {}

    def step(name, fn, rebalances, moved):
        """fn() timed; gated on its (rebalances, ragged moves)."""
        c0 = (ht.LAYOUT_STATS["rebalances"], ht.MOVE_STATS["ragged_moves"])
        out, host, ev = timed(fn)
        got = (ht.LAYOUT_STATS["rebalances"] - c0[0], ht.MOVE_STATS["ragged_moves"] - c0[1])
        check(got == (rebalances, moved), f"[dist] layout {name}: (rebalances, moves) {got}, want {(rebalances, moved)}")
        steps[name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives, "received": timed.received}
        return out

    def received(name, old, new, op="flatmove.ragged"):
        """The move of ``name`` brought exactly the rows of this rank's new range it did not hold."""
        a, b, c, d = sum(new[:rank]), sum(new[: rank + 1]), sum(old[:rank]), sum(old[: rank + 1])
        want = ((b - a) - max(0, min(b, d) - max(a, c))) * row_bytes
        got = steps[name]["received"].get(op, 0)
        check(got == want, f"[dist] layout {name}: received {got} B, the rows it lacked are {want} B")
        moves[name] = {"bytes": got, "gb_per_s": got / steps[name]["host_s"] / 1e9}

    def tmap(counts):
        t = np.tile(np.asarray([n, F_MAIN], dtype=np.int64), (world, 1))
        t[:, 0] = counts
        return t

    # ---- the ceil-div reference, outside the path
    x0 = ht.array(x_np, is_split=0)
    del x_np
    mu0, sd0 = ht.mean(x0, axis=0), ht.std(x0, axis=0)
    z0 = (x0 - mu0) / sd0
    init = z0[:K_MAIN].resplit(None)
    km0 = ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(z0)
    nz0 = ht.nonzero(ht.abs(z0) > 2)
    sum0, max0, abs0 = z0.sum().item(), z0.max().item(), float(ht.sum(ht.abs(z0)).item())
    c0 = km0.cluster_centers_.larray
    launches = {}
    for tag, kind in (("skewed", "tail"), ("empty shard", "empty")):
        counts = layout_counts(n, layout_shares(world, kind))
        head = counts[::-1]
        x = x0.copy()
        ht.kernels.reset_kernel_stats()
        step(f"{tag}: redistribute_", lambda: x.redistribute_(target_map=tmap(counts)), 0, int(counts != canon))
        check(list(x.lshape_map[:, 0]) == counts and x.lshape[0] == counts[rank], f"[dist] layout {tag}: lshape_map")
        if counts != canon:
            received(f"{tag}: redistribute_", canon, counts)
        mom = ht.LAUNCHES["moments_onepass"]
        z = step(f"{tag}: standardize", lambda: (x - ht.mean(x, axis=0)) / ht.std(x, axis=0), 0, 0)
        check(ht.LAUNCHES["moments_onepass"] - mom == (1 if counts[rank] else 0),
              f"[dist] layout {tag}: moments_onepass launches {ht.LAUNCHES['moments_onepass'] - mom} on "
              f"{counts[rank]} rows")
        check(z.lcounts == x.lcounts, f"[dist] layout {tag}: z's layout {z.lcounts}")
        mu, sd = ht.mean(x, axis=0).larray, ht.std(x, axis=0).larray
        e_mu = (mu - mu0.larray).abs().max().item()
        e_sd = (sd - sd0.larray).abs().max().item()
        check(bool(((mu - mu0.larray).abs() <= MEAN_ATOL + MEAN_RTOL * mu0.larray.abs()).all())
              and bool(((sd - sd0.larray).abs() <= M2_RTOL * sd0.larray.abs()).all()),
              f"[dist] layout {tag}: mean/std against the ceil-div layout's: {e_mu}, {e_sd}")
        same = torch.equal(mu, mu0.larray) and torch.equal(sd, sd0.larray)
        del x
        y = x0.copy()
        step(f"{tag}: y redistribute_ (head-skewed)", lambda: y.redistribute_(target_map=tmap(head)), 0,
             int(head != canon))
        w = step(f"{tag}: z + y", lambda: z + y, 0, int(head != counts))
        check(w.lcounts == z.lcounts, f"[dist] layout {tag}: z + y's layout {w.lcounts}")
        if head != counts:
            received(f"{tag}: z + y", head, counts)
        del y, w

        cs, nz, s, m, cp, a = (step(f"{tag}: {name}", fn, 0, 0) for name, fn in (
            ("cumsum", lambda: ht.cumsum(z, 0)), ("nonzero", lambda: ht.nonzero(ht.abs(z) > 2)),
            ("sum", lambda: z.sum()), ("max", lambda: z.max()), ("copy", lambda: z.copy()),
            ("astype", lambda: z.astype(ht.float64))))
        check(cs.lcounts == cp.lcounts == a.lcounts == z.lcounts, f"[dist] layout {tag}: layouts of step 5")
        bound = 2 * accumulation_bound(n * F_MAIN, abs0) + 2 * F32_UNIT_ROUNDOFF * abs0
        check(abs(s.item() - sum0) <= bound, f"[dist] layout {tag}: sum {s.item()} vs {sum0} (bound {bound})")
        if same:  # z is z0's bits in another layout: nonzero and max are exact
            check(nz.gshape == nz0.gshape and torch.equal(nz.larray, nz0.larray) and m.item() == max0,
                  f"[dist] layout {tag}: nonzero {nz.gshape} vs {nz0.gshape}, max {m.item()} vs {max0}")
        del cs, nz, cp, a
        lloyd = ht.LAUNCHES["lloyd_fused"]
        km = step(f"{tag}: KMeans fit", lambda: ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS,
                                                                    tol=None).fit(z), int(counts != canon),
                  int(counts != canon))
        check(ht.LAUNCHES["lloyd_fused"] - lloyd == ITERS + 1, f"[dist] layout {tag}: lloyd_fused launches "
                                                                f"{ht.LAUNCHES['lloyd_fused'] - lloyd}")
        check(z.balanced, f"[dist] layout {tag}: the fit left z ragged")
        if counts != canon:
            received(f"{tag}: KMeans fit", counts, canon)
        # z, rebalanced by the fit, against the ceil-div run's: |dz| <= (|dmu| + |z| |dsd|) / sd + 4 u |z|
        dz = (z.larray - z0.larray).abs()
        zb = ((mu - mu0.larray).abs() + z0.larray.abs() * (sd - sd0.larray).abs()) / sd0.larray \
            + 4 * F32_UNIT_ROUNDOFF * z0.larray.abs()
        check(bool((dz <= zb).all()), f"[dist] layout {tag}: z against the ceil-div run: max {dz.max().item()}")
        check(torch.equal(km.labels_.larray, km0.labels_.larray), f"[dist] layout {tag}: labels differ from the "
                                                                   f"ceil-div fit's")
        e_c = (km.cluster_centers_.larray - c0).abs().max().item()
        check(e_c <= CENTERS_RTOL * c0.abs().max().item(), f"[dist] layout {tag}: centres {e_c}")
        for name, t in (("mean", mu), ("std", sd), ("centres", km.cluster_centers_.larray)):
            same_everywhere(t, f"layout {tag} {name}")
        launches[tag] = {k: v for k, v in ht.LAUNCHES.items() if v}
        say(f"layout {tag} {counts}: " + "; ".join(
            f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events" for k, v in steps.items() if k.startswith(tag))
            + f"; moves " + ", ".join(f"{k.split(': ')[1]} {v['bytes']} B at {v['gb_per_s']:.3f} GB/s"
                                       for k, v in moves.items() if k.startswith(tag))
            + f"; mean/std {'bit-identical to' if same else 'within the merge bound of'} the ceil-div run's "
              f"({e_mu:.3e}, {e_sd:.3e}), labels identical, centres {e_c:.3e}; launches {launches[tag]}")
        del z, km
        torch.cuda.empty_cache()
    del z0, km0, nz0, mu0, sd0

    # ---- beside the path: ring and Ulysses attention
    att = {}
    for na in (N_ATT_CARD * world, N_ATT_CARD * world - 3):
        q_np, k_np, v_np = attention_qkv(seed, na)
        a_lo, a_n = comm.chunk((na,), 0)[0], comm.chunk((na,), 0)[1][0]
        q, k, v = (torch.from_numpy(t).to(dev).transpose(0, 1).contiguous() for t in (q_np, k_np, v_np))  # (H, N, D)
        qr, kr, vr = (ht.array(t[:, a_lo : a_lo + a_n], is_split=1) for t in (q, k, v))
        qu, ku, vu = (ht.array(t[a_lo : a_lo + a_n], is_split=0) for t in (q_np, k_np, v_np))
        del q_np, k_np, v_np
        pick = np.random.default_rng(seed + rank).choice(a_n, min(ATT_SAMPLES, a_n), replace=False)
        pick.sort()
        for causal in (False, True):
            key = f"N={na} {'causal' if causal else 'full'}"
            ring, t_r, ev_r = timed(lambda: ht.parallel.ring_attention(qr, kr, vr, causal=causal))
            c_ring = timed.collectives
            uly, t_u, ev_u = timed(lambda: ht.parallel.ulysses_attention(qu, ku, vu, causal=causal))
            c_uly = timed.collectives
            want_r = {"ring_shift": 2 * (world - 1)} if world > 1 else {}
            check({k_: v_["calls"] for k_, v_ in c_ring.items()} == want_r, f"[dist] ring attention {key}: {c_ring}")
            check({k_: v_["calls"] for k_, v_ in c_uly.items()} == {"alltoall": 2}, f"[dist] ulysses {key}: {c_uly}")
            w_r, e_r = attention_check(f"[dist] ring {key}", ring.larray[:, pick], q, k, v, a_lo + pick, causal)
            w_u, e_u = attention_check(f"[dist] ulysses {key}", uly.larray[pick].transpose(0, 1), q, k, v,
                                       a_lo + pick, causal)
            e_ru = (ring.larray - uly.larray.transpose(0, 1)).abs().max().item()
            att[key] = {"ring_host_s": t_r, "ring_ms": ev_r, "ulysses_host_s": t_u, "ulysses_ms": ev_u,
                        "ring_calls": c_ring, "ulysses_calls": c_uly, "e_ring": e_r, "w_ring": w_r, "e_uly": e_u,
                        "w_uly": w_u, "e_ring_uly": e_ru}
            del ring, uly
        del q, k, v, qr, kr, vr, qu, ku, vu
        torch.cuda.empty_cache()
    say("attention (H, N, D) = (8, N, 128): " + "; ".join(
        f"{k_} ring {v_['ring_ms']:.4f} ms ({v_['ring_calls']}), ulysses {v_['ulysses_ms']:.4f} ms "
        f"({v_['ulysses_calls']}), float64 {v_['e_ring']:.3e} / {v_['e_uly']:.3e} ({v_['w_ring']:.3f} / "
        f"{v_['w_uly']:.3f} of the bound), ring vs ulysses {v_['e_ring_uly']:.3e}" for k_, v_ in att.items()))

    # ---- halo_exchange, ring_map, ring_reduce, bucket_move
    halo, t_h, ev_h = timed(lambda: ht.parallel.halo_exchange(x0, 2))
    c_h = timed.collectives
    xl = x0.larray
    ends = comm.allgather(torch.cat([xl[:2], xl[-2:]]).unsqueeze(0), 0, [1] * world)
    ext = halo.larray[0]
    check(halo.gshape == (world, canon[0] + 4, F_MAIN) and torch.equal(ext[2:-2], xl)
          and torch.equal(ext[:2], ends[(rank - 1) % world][2:]) and torch.equal(ext[-2:], ends[(rank + 1) % world][:2]),
          "[dist] halo_exchange: blocks or halos")
    a = ht.array(xl[:N_ATT_CARD], is_split=0)
    d2 = _quadratic_expand
    rm, t_rm, ev_rm = timed(lambda: ht.parallel.ring_map(d2, a, a))
    c_rm = timed.collectives
    cd = ht.spatial.cdist(a, a, quadratic_expansion=True, use_ring=True).larray
    # cdist = sqrt(d2) of the same tiles: cd^2 = d2 (1 + d1)^2 (1 + d2'), within 3.01 u d2 of it
    e_rm = ((rm.larray - cd * cd).abs() - 4 * F32_UNIT_ROUNDOFF * rm.larray.abs()).max().item()
    check(e_rm <= 0, f"[dist] ring_map against cdist(use_ring=True)^2 beyond 4 u d2: {e_rm}")
    rr, t_rr, ev_rr = timed(lambda: ht.parallel.ring_reduce(
        lambda u, w_: d2(u, w_).amin(1), torch.minimum, lambda u: torch.full((u.shape[0],), float("inf"), device=dev),
        a, a))
    c_rr = timed.collectives
    check(torch.equal(rr.larray, rm.larray.amin(1)), "[dist] ring_reduce's row minima against ring_map's")
    del rm, cd, rr, a
    torch.cuda.empty_cache()
    matrix = [layout_counts(canon[r], layout_shares(world, "tail")) for r in range(world)]
    seg = [sum(matrix[rank][:d]) for d in range(world + 1)]
    sums = torch.stack([xl[seg[d] : seg[d + 1]].double().sum(0) for d in range(world)])  # what each rank gets of mine
    sent = comm.allgather(sums.unsqueeze(0), 0, [1] * world)  # (P, P, F)
    before = dict(ht.MOVE_STATS)
    got, t_b, ev_b = timed(lambda: flatmove.bucket_move(xl, 0, matrix, comm))
    c_b, r_b = timed.collectives, timed.received.get("flatmove.bucket", 0)
    check({k_: ht.MOVE_STATS[k_] - before[k_] for k_ in ("ragged_moves", "bucket_moves")} ==
          {"ragged_moves": 1, "bucket_moves": 1}, "[dist] bucket_move's MOVE_STATS")
    inc = [matrix[r][rank] for r in range(world)]
    check(got.shape[0] == sum(inc) and r_b == (sum(inc) - inc[rank]) * row_bytes,
          f"[dist] bucket_move received {got.shape[0]} rows, {r_b} B")
    off = np.concatenate([[0], np.cumsum(inc)])
    gsum = torch.stack([got[off[r] : off[r + 1]].double().sum(0) for r in range(world)])
    check(bool(torch.allclose(gsum, sent[:, rank], rtol=1e-12, atol=1e-9)), "[dist] bucket_move: the rows received")
    say(f"halo_exchange (halo 2) {ev_h:.4f} ms ({c_h}); ring_map of squared distances at {N_ATT_CARD} rows a card "
        f"{ev_rm:.4f} ms ({c_rm}), ring_reduce {ev_rr:.4f} ms; bucket_move of {canon[rank]} rows (matrix row "
        f"{matrix[rank]}) {ev_b:.4f} ms, received {r_b} B at {r_b / t_b / 1e9 if r_b else 0.0:.3f} GB/s ({c_b})")
    steps.update({"halo_exchange": {"host_s": t_h, "event_ms": ev_h, "collectives": c_h},
                  "ring_map": {"host_s": t_rm, "event_ms": ev_rm, "collectives": c_rm},
                  "ring_reduce": {"host_s": t_rr, "event_ms": ev_rr, "collectives": c_rr},
                  "bucket_move": {"host_s": t_b, "event_ms": ev_b, "collectives": c_b}})
    moves["bucket_move"] = {"bytes": r_b, "gb_per_s": r_b / t_b / 1e9 if r_b else 0.0}
    del got, halo, x0, xl
    torch.cuda.empty_cache()
    return {"steps": steps, "moves": moves, "launches": launches, "attention": att}


def dist_phase(world: int, seed: int = 0) -> dict:
    """[dist]: the main path at world size ``world`` (one process per card,
    NCCL; weak scaling: N_MAIN rows per card), then the single-process port
    on the same global data in this process, and the comparison; then the
    layout path's steps (:func:`_dist_layout`). Returns rank 0's kernel
    launches on the layout path."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import heat_tpu_torch as ht
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    tmp = stream_space("[dist]", "chip_smoke_dist_")  # the ranks' stream steps write a 2 GiB file here
    try:
        mnist_files(os.path.join(tmp, "mnist"), seed + TRAIN_SEED_OFFSET)  # the training steps' data, for every rank
        print(f"[dist] spawning {world} rank(s) over NCCL, {N_MAIN} x {F_MAIN} rows per card", flush=True)
        t0 = time.perf_counter()
        mp.start_processes(_dist_rank, args=(world, os.path.join(tmp, "store"), tmp, seed), nprocs=world, join=True,
                           start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
        print(f"[dist] {world} rank(s) done in {time.perf_counter() - t0:.1f} s (spawn and start included)", flush=True)

        # the single-process port on the same global data, the ranks' standardization applied
        ht.use_device("gpu")
        dev = ht.get_device().torch_device
        true, member, x, member_q, xq = _dist_data(ht, world)
        mu0, sd0 = ht.mean(x, axis=0).larray, ht.std(x, axis=0).larray
        mu, sd = ranks[0]["mu"].to(dev), ranks[0]["sd"].to(dev)
        check(bool(((mu - mu0).abs() <= MEAN_ATOL + MEAN_RTOL * mu0.abs()).all()), "[dist] mean vs one process")
        check(bool(((sd - sd0).abs() <= M2_RTOL * sd0.abs()).all()), "[dist] std vs one process")
        z = (x - ht.array(mu)) / ht.array(sd)
        del x
        km0 = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
        c0 = km0.cluster_centers_.larray
        c = ranks[0]["centers"].to(dev)
        cdiff = (c - c0).abs().max().item()
        check(cdiff <= CENTERS_RTOL * c0.abs().max().item(), f"[dist] centroids vs one process: {cdiff}")
        check(abs(ranks[0]["inertia"] - km0.inertia_) <= INERTIA_RTOL * abs(km0.inertia_), "[dist] inertia")
        labels = torch.cat([r["labels"] for r in ranks]).to(dev).long()
        ldiff = labels != km0.labels_.larray
        near_rows = 0
        if bool(ldiff.any()):
            rows = torch.nonzero(ldiff).flatten()
            two = torch.topk(_quadratic_expand(z.larray[rows], c0), 2, dim=1, largest=False).values
            near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
            check(bool(near.all()), "[dist] labels differ from one process outside near-ties")
            near_rows = int(near.sum())
        zq = (xq - ht.array(mu)) / ht.array(sd)
        pred0 = km0.predict(zq).larray
        pdiff = int((torch.cat([r["pred"] for r in ranks]).to(dev) != pred0).sum())
        train, train_labels = z[:N_TRAIN], member[:N_TRAIN]
        d0, i0 = ht.spatial.nearest_neighbors(zq, train, KNN_K)
        d, i = torch.cat([r["d_nn"] for r in ranks]).to(dev), torch.cat([r["i_nn"] for r in ranks]).to(dev)
        e_d, nd, worst = knn_check(zq.larray, train.larray, d, i, d0.larray, i0.larray)
        knn0 = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, train_labels).predict(zq).larray
        knn = torch.cat([r["knn_pred"] for r in ranks]).to(dev)
        kdiff = knn != knn0
        check(not bool((kdiff & ~(i != i0.larray).any(dim=1)).any()),
              "[dist] kNN labels differ from one process where the neighbours are the same")
        # one card's share, timed on one card: the weak-scaling baseline
        z1 = z[:N_MAIN]
        init1 = z1[:K_MAIN]
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ht.cluster.KMeans(n_clusters=K_MAIN, init=init1, max_iter=ITERS, tol=None).fit(z1)
            torch.cuda.synchronize()
            t1 = time.perf_counter() - t1
        del z, z1, zq, train, km0, xq, member
        torch.cuda.empty_cache()
        A = _dist_qr_data(ht, world)
        r0 = ht.linalg.qr(A, calc_q=False).R.larray
        del A
        torch.cuda.empty_cache()

        def sign_normalized(r):
            s_ = torch.sign(torch.diagonal(r))
            return r * torch.where(s_ == 0, torch.ones_like(s_), s_)[:, None]

        r_diff = (sign_normalized(ranks[0]["R"].to(dev)) - sign_normalized(r0)).abs().max().item() / r0.abs().max().item()
        check(r_diff <= QR_R_RTOL, f"[dist] R vs one process's R: {r_diff}")
        ref = _ridge_reference(ht, world, ranks, tmp)
        lref = _linalg_reference(ht, world, ranks, tmp)
        torch.cuda.empty_cache()
        rref = _robust_reference(ht, world, ranks)
        rg = ranks[0]["ridge"]
        print(f"[dist] ridge n={N_RIDGE_CARD * world}: chol_panel_fused launches per rank "
              f"{[r['ridge']['launches']['chol_panel_fused'] for r in ranks]} (panels of {rg['bs']} rows), routes "
              f"{[{k: v for k, v in r['ridge']['stats'].items() if k.startswith('chol_panel_fused')} for r in ranks]}; "
              f"||L L^T - K||max/||K||max {rg['recon']:.3e}, ||K alpha - y||/||y|| {rg['resid']:.3e}; rbf use_ring vs "
              f"default {rg['ring_diff']:.3e} (bound {rg['ring_bound']:.3e}); L vs the one-process factor of the same "
              f"K: ||dL||_F {ref['diff_fro']:.3e} (bound {ref['bound']:.3e}), max abs {ref['diff_max']:.3e}; "
              f"one-process cholesky of K on one card {ref['t_one'][0]:.4f} s host first call, {ref['t_one'][1]:.4f} s "
              f"warm", flush=True)
        for r in ranks:
            print(f"[dist] ridge r{r['rank']}: " + "; ".join(
                f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, COLLECTIVES {v['collectives']}"
                for k, v in r["ridge"]["steps"].items()) + f"; ring rbf {r['ridge']['ring_host_s']:.4f} s host, "
                f"{r['ridge']['ring_event_ms']:.4f} ms events, COLLECTIVES {r['ridge']['ring_collectives']}; warm: "
                + ", ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events"
                            for k, v in r["ridge"]["warm"].items()), flush=True)
        for r in ranks:
            print(f"[dist] lu/solvers r{r['rank']}: " + _steps_line(r["lu"]["steps"]), flush=True)
            print(f"[dist] lu/solvers warm r{r['rank']}: " + _steps_line(r["lu"]["warm"]), flush=True)
            print(f"[dist] svd r{r['rank']}: " + _steps_line(r["svd"]["steps"]), flush=True)
            print(f"[dist] spectral r{r['rank']}: " + _steps_line(r["spectral"]["steps"]), flush=True)
        slowest = lambda part, name: max(r[part]["steps"][name]["host_s"] for r in ranks)
        print(f"[dist] solve n={N_RIDGE_CARD * world} ({ranks[0]['lu']['panels']} panels of {ranks[0]['lu']['bs']} "
              f"rows): {world} card(s) {slowest('lu', 'solve'):.4f} s (slowest rank, first call), "
              f"{max(r['lu']['warm']['solve']['host_s'] for r in ranks):.4f} s warm; one card "
              f"torch.linalg.solve of the same K {lref['solve']['t'][0]:.4f} s first, {lref['solve']['t'][1]:.4f} s "
              f"warm; ||x - x_one|| {lref['solve']['diff']:.3e}", flush=True)
        print(f"[dist] svd+lstsq {N_SVD * world} x {F_SVD}: {world} card(s) svd {slowest('svd', 'svd'):.4f} s, lstsq "
              f"{slowest('svd', 'lstsq'):.4f} s (first calls); one card svd(compute_uv=False)+lstsq "
              f"{lref['svd']['t'][0]:.4f} s first, {lref['svd']['t'][1]:.4f} s warm; S vs one card {lref['svd']['e_s']:.3e} "
              f"(<= {lref['svd']['s_bound']:.3e}), "
              f"||x - x_one|| {lref['svd']['e_x']:.3e}; lstsq route {ranks[0]['svd']['route']}; lstsq at "
              f"{N_LSTSQ_CARD * world} x {F_SVD} (QR route) {slowest('svd', 'lstsq (QR route)'):.4f} s, vs float64 "
              f"{ranks[0]['svd']['qr_route']['e']:.3e} (<= {ranks[0]['svd']['qr_route']['bound']:.3e})", flush=True)
        print(f"[dist] spectral {N_SPEC} x {F_SPEC} (strong scaling): {world} card(s) fit "
              f"{slowest('spectral', 'fit'):.4f} s, predict {slowest('spectral', 'predict'):.4f} s; one card "
              f"draws+standardize+fit {lref['spectral']['t']:.4f} s; labels equal up to a permutation, Ritz values "
              f"max abs diff {lref['spectral']['e_ritz']:.3e}; float64 ||L v - theta v|| / ||L|| of the ranks' "
              f"{K_SPEC} smallest Ritz pairs against one card's L "
              f"{[f'{r:.3e}' for r in lref['spectral']['resid_x']]} (<= {RITZ_RESID_RTOL})", flush=True)
        rb = ranks[0]["robust"]
        print(f"[dist] robust {N_ROBUST * world} x {F_ROBUST} (weak scaling, {N_ROBUST} rows per card): against one "
              f"process on the same data, x, z, the sort's values and indices, the cross-rank write and the KMedians "
              f"labels equal chunk by chunk, percentiles, median, KMedians centres ({rb['n_iter']} iterations), unique "
              f"and topk equal; sort received per rank "
              f"{[r['robust']['sort_received'] for r in ranks]} B against 3x the share {3 * rb['sort_share']} B; "
              f"slowest rank (first calls): " + ", ".join(
                  f"{k} {max(r['robust']['steps'][k]['host_s'] for r in ranks):.4f} s" for k in rb["steps"])
              + "; one card on the whole data: " + ", ".join(f"{k} {v:.4f} s" for k, v in rref.items()), flush=True)
        for r in ranks:
            print(f"[dist] robust r{r['rank']}: " + _steps_line(r["robust"]["steps"]), flush=True)
        dt = [r["dtypes"] for r in ranks]
        print(f"[dist] dtypes (weak scaling): convolve of {N_CONV} samples per card ({N_CONV * world} in all) over "
              f"the halos, slowest rank (first calls): " + ", ".join(
                  f"{m} {max(d['steps'][f'convolve {m}']['host_s'] for d in dt):.4f} s" for m in ("full", "same", "valid"))
              + "; warm, CUDA-event ms (slowest rank): " + ", ".join(
                  f"{m} {max(d['steps'][f'warm convolve {m}']['event_ms'] for d in dt):.4f}"
                  for m in ("full", "same", "valid"))
              + "; one card on the whole signal, first / warm: " + ", ".join(
                  f"{m} {dt[0]['steps'][f'one card convolve {m}']['host_s']:.4f} s / "
                  f"{dt[0]['steps'][f'warm one card convolve {m}']['event_ms']:.4f} ms" for m in ("full", "same", "valid"))
              + f"; worst share of the bound per rank {[d['worst'] for d in dt]}; vdot {dt[0]['vdot']} (error "
              f"{dt[0]['vdot_err']:.3e} <= {dt[0]['vdot_bound']:.3e})", flush=True)
        for r in ranks:
            print(f"[dist] dtypes r{r['rank']}: " + _steps_line(r["dtypes"]["steps"]), flush=True)
        sref = _stream_reference(ht, world, ranks, tmp)
        sst = [r["stream"] for r in ranks]
        print(f"[dist] stream {N_MAIN} x {F_MAIN} in all (strong scaling), {sst[0]['chunks']} chunks of {STREAM_CHUNK} "
              f"rows: a save from {world} rank(s) loads back equal, each rank read only its rows; COLLECTIVES per rank: "
              f"moments pass {[s['steps']['StreamingMoments pass']['collectives'] for s in sst]}, fit "
              f"{[s['steps']['StreamingKMeans fit']['collectives'] for s in sst]}, merge_processes "
              f"{[s['steps']['merge_processes']['collectives'] for s in sst]} ({sst[0]['rounds']} tree_merge rounds); "
              f"moments within {sref['worst']:.3f} of the merge bound of float64, centres {sref['centres']:.3f} of the "
              f"accumulation bound of one card's KMeans; slowest rank (first calls): " + ", ".join(
                  f"{k} {max(s['steps'][k]['host_s'] for s in sst):.4f} s" for k in sst[0]["steps"])
              + f"; one card's moments pass over the same file {sref['t_one_pass']:.4f} s", flush=True)
        tm = ranks[0]["times_max"]
        print(f"[dist] world size {world}; per rank: launches {[r['launches'] for r in ranks]}; fit COLLECTIVES "
              f"{ranks[0]['fit_collectives']}; qr local routes {[r['qr_routes'] for r in ranks]}", flush=True)
        print(f"[dist] vs one process on the same {N_MAIN * world} x {F_MAIN} data: mean/std within their bounds; "
              f"centroids max abs {cdiff:.3e}; labels differ on {int(ldiff.sum())} rows ({near_rows} near-tie); "
              f"predict differs on {pdiff} of {N_QUERY}; kNN distances max abs {e_d:.3e}, indices differ on {nd} "
              f"entries (largest gap {worst:.3f} of the bound), labels on {int(kdiff.sum())}; R {r_diff:.3e} of max |R|; "
              f"||QR - A||/||A|| {ranks[0]['qr_resid']:.3e}, ||QᵀQ - I|| {ranks[0]['qr_ortho']:.3e}", flush=True)
        names = ["mean+std", "first fit", "warm fit", "kNN predict", "warm kNN predict", "warm mean+std", "qr",
                 "warm qr", "matmul(A.T, A)", "warm matmul", "resplit 0->1->None", "whole path"]
        print("[dist] slowest rank's host times (s): " + ", ".join(f"{n} {t:.4f}" for n, t in zip(names, tm)), flush=True)
        print("[dist] CUDA-event ms per rank: " + "; ".join(
            f"r{r['rank']}: " + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, r["events"])) for r in ranks), flush=True)
        print(f"[dist] warm fit: {world} card(s) x {N_MAIN} rows {tm[2]:.4f} s ({ITERS / tm[2]:.1f} it/s); one card, "
              f"{N_MAIN} rows, one process {t1:.4f} s; weak-scaling efficiency t(1 card) / t({world} cards) "
              f"{t1 / tm[2]:.3f}", flush=True)
        lay = [r["layout"] for r in ranks]
        for r, lr in enumerate(lay):
            print(f"[dist] layout r{r}: " + _steps_line(lr["steps"]) + "; moves " + ", ".join(
                f"{k} {v['bytes']} B at {v['gb_per_s']:.3f} GB/s" for k, v in lr["moves"].items()), flush=True)
        slow = {k: max(lr["steps"][k]["host_s"] for lr in lay) for k in lay[0]["steps"]}
        print(f"[dist] layout path at {N_MAIN} x {F_MAIN} rows a card ({N_MAIN * world} in all), slowest rank's host s: "
              + ", ".join(f"{k} {v:.4f}" for k, v in slow.items()) + "; attention, slowest rank's CUDA-event ms: "
              + ", ".join(f"{k} ring {max(lr['attention'][k]['ring_ms'] for lr in lay):.4f} / ulysses "
                          f"{max(lr['attention'][k]['ulysses_ms'] for lr in lay):.4f}" for k in lay[0]["attention"])
              + f"; launches per rank {[lr['launches'] for lr in lay]}", flush=True)
        for r in ranks:
            print(f"[dist] train r{r['rank']}: " + _steps_line(r["train"]["steps"]), flush=True)
        t_ref = time.perf_counter()
        tref = _train_reference(ht, world, ranks, tmp, seed)
        t_ref = time.perf_counter() - t_ref
        tr = [r["train"] for r in ranks]
        print(f"[dist] train at {world} card(s): slowest rank's wall {max(t['wall'] for t in tr):.1f} s (DataParallel "
              f"epoch {max(t['dp']['t_epoch'] for t in tr):.4f} s, {MNIST_BATCH * tr[0]['dp']['steps'] / max(t['dp']['t_epoch'] for t in tr):.0f} "
              f"images/s; GaussianNB fit {max(t['steps']['GaussianNB fit']['host_s'] for t in tr):.4f} s; Lasso "
              f"{LASSO_DIST_ITERS} sweeps {max(t['steps']['Lasso fit']['host_s'] for t in tr):.4f} s"
              + (f"; DASO {DASO_DIST_BATCHES} batches {max(t['daso']['t'] for t in tr):.4f} s" if "daso" in tr[0] else "")
              + f"); the one-process references {t_ref:.1f} s; {tref}", flush=True)
        fr = [r["frame"] for r in ranks]
        print(f"[dist] frame at {world} card(s) on TPC-H SF 10 split by rank (strong scaling against [frame]'s one card "
              f"times), slowest rank (first calls): " + ", ".join(
                  f"{k} {max(f['steps'][k]['host_s'] for f in fr):.4f} s" for k in fr[0]["steps"])
              + f"; range-mode groups per rank {fr[0]['range_lcounts']} (<= 2 G / P + 32); frame and resilience wall "
              f"{max(f['wall'] for f in fr):.1f} s", flush=True)
        sv = [r["serve"] for r in ranks]
        for r, v in zip(ranks, sv):
            if v["sup_centers"] is not None:
                sdiff = (v["sup_centers"].to(dev) - c0).abs().max().item()
                check(sdiff <= CENTERS_RTOL * c0.abs().max().item(),
                      f"[dist] rank {r['rank']}'s supervised centres vs one process: {sdiff}")
        print(f"[dist] serve at {world} card(s): supervised fit with device_loss at step {SUP_FAULT_STEP}: detached "
              f"{[v['sup_detached'] for v in sv]}, groups {[v['sup']['sizes'] for v in sv]}, survivors' centres within "
              f"{CENTERS_RTOL} of one process's max |c|, lloyd_fused launches {[v['sup']['launches'] for v in sv]}, "
              f"slowest {max(v['sup']['host_s'] for v in sv):.4f} s; the service: rows {[v['serve']['rows'] for v in sv]}, "
              f"DegradeError {[v['serve']['errors'] for v in sv]}, group events {sv[0]['serve']['events']}, process "
              f"groups held per rank before the trace and after each event {[v['serve']['groups_held'] for v in sv]}, slowest "
              f"trace {max(v['serve']['secs'] for v in sv):.4f} s, serve wall {max(v['wall'] for v in sv):.1f} s",
              flush=True)
        path = {}
        for per_map in lay[0]["launches"].values():
            for k, v in per_map.items():
                path[k] = path.get(k, 0) + v
        return path
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- [layout]: ragged layouts, the flatmove primitives, tiles and the attentions
LAYOUT_SEED_OFFSET = 200  # [layout]'s and [dist]'s layout steps draw their numpy streams from --seed + this
LAYOUT_SLAB = 1 << 20      # rows of one independently seeded slab of the layout data
LAYOUT_ROWS = (0, 1, 1023, (1 << 21) + 7)  # row counts of the kernel checks, beside the path's ragged shards
N_LAYOUT_PATH = 1 << 26    # the path's rows at four cards, whose shard sizes the kernels are checked at
H_ATT, D_ATT, N_ATT_ONE, N_ATT_CARD = 8, 128, 1 << 15, 1 << 13  # attention: one card's N, and [dist]'s per card
ATT_SAMPLES = 256          # query rows a head (a rank's) held against float64
ATT_TPP = 64               # SquareDiagTiles' tiles per process on the 2^24 x 32 data


def layout_shares(world, kind):
    """Row shares of the path's maps: ``tail`` (0.40, 0.30, 0.20, 0.10) at four ranks (w, w - 1, ..., 1 over their
    sum at w), ``head`` its reverse, ``empty`` (0.50, 0.25, 0.25, 0) (half on the first rank, none on the last)."""
    if kind == "empty":
        return [1.0] if world == 1 else [1.0, 0.0] if world == 2 else \
            [0.5] + [0.5 / (world - 2)] * (world - 2) + [0.0]
    w = [float(world - r) for r in range(world)]
    w = [v / sum(w) for v in w]
    return w if kind == "tail" else w[::-1]


def layout_counts(n, shares):
    """An integer partition of n by ``shares`` (largest remainders, ties to the lower rank)."""
    raw = [n * s for s in shares]
    counts = [int(math.floor(v)) for v in raw]
    for r in sorted(range(len(raw)), key=lambda r: (counts[r] - raw[r], r))[: n - sum(counts)]:
        counts[r] += 1
    return counts


def layout_blobs(seed, n, lo, hi):
    """Rows [lo, hi) of [main]'s blob recipe at n rows (k = 8, f = 32, float32) with numpy: the centres from
    ``seed``, each LAYOUT_SLAB-row slab of memberships and noise from its own child stream, so that a rank draws
    only its rows and every world size sees the same global array."""
    import concurrent.futures

    import numpy as np

    centres = (np.random.default_rng(seed).standard_normal((K_MAIN, F_MAIN)) * 8.0).astype(np.float32)
    kids = np.random.SeedSequence(seed + 1).spawn(-(-n // LAYOUT_SLAB))
    out = np.empty((hi - lo, F_MAIN), np.float32)

    def fill(s):
        a, b = s * LAYOUT_SLAB, min((s + 1) * LAYOUT_SLAB, n)
        rng = np.random.default_rng(kids[s])
        member = rng.integers(0, K_MAIN, b - a)
        if a == 0:
            member[:K_MAIN] = np.arange(K_MAIN)
        slab = rng.standard_normal((b - a, F_MAIN), dtype=np.float32) + centres[member]
        c, d = max(a, lo), min(b, hi)
        out[c - lo : d - lo] = slab[c - a : d - a]

    slabs = range(lo // LAYOUT_SLAB, -(-hi // LAYOUT_SLAB))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, slabs))
    return out


def attention_qkv(seed, n, lo=0, hi=None):
    """Rows [lo, hi) of the (n, H_ATT, D_ATT) float32 q, k and v from ``seed`` (N(0, 1), one stream per tensor and
    LAYOUT_SLAB-row slab, so that a rank may draw its rows alone)."""
    import numpy as np

    hi = n if hi is None else hi
    out = []
    for t in range(3):
        kids = np.random.SeedSequence(seed + 10 + t).spawn(-(-n // LAYOUT_SLAB))
        parts = []
        for s in range(lo // LAYOUT_SLAB, -(-hi // LAYOUT_SLAB)):
            a, b = s * LAYOUT_SLAB, min((s + 1) * LAYOUT_SLAB, n)
            slab = np.random.default_rng(kids[s]).standard_normal((b - a, H_ATT, D_ATT), dtype=np.float32)
            parts.append(slab[max(a, lo) - a : min(b, hi) - a])
        out.append(np.concatenate(parts))
    return out


def attention_check(tag, out_hnd, q, k, v, rows, causal):
    """``out_hnd`` (H, len(rows), D), the attention of the query rows at the global positions ``rows``, against float64 dense attention of the same rows over all N keys of the (H, N, D) tensors q, k and v. The bound
    per row, from the online fold's error (Higham and Mary's probabilistic bound, lambda = SUM_LAMBDA): a score is a
    float32 sum of D products scaled once, within eta = lambda sqrt(D) u scale max_j sum_d |q_d k_jd| + 2 u of the
    exact one, which moves each softmax weight by a factor within 2 eta (the exp's rounding included) and so the
    output, a convex combination of rows of v, by 2 eta max|v|; the float32 sums of the numerator and denominator
    over N keys (and two rescalings a key slice) add 2 lambda sqrt(N + 2 S) u max|v| each, S <= N. Returns the worst
    share of the bound and the max abs error."""
    import torch

    n, d = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    q64, k64, v64 = q[:, rows].double(), k.double(), v.double()
    s = torch.matmul(q64, k64.transpose(1, 2)) * scale
    pos = torch.as_tensor(rows, device=s.device)
    if causal:
        s = s.masked_fill(torch.arange(n, device=s.device)[None, None, :] > pos[None, :, None], float("-inf"))
    ref = torch.matmul(torch.softmax(s, dim=-1), v64)
    eta = SUM_LAMBDA * math.sqrt(d) * F32_UNIT_ROUNDOFF * scale * torch.matmul(q64.abs(), k64.abs().transpose(1, 2)) \
        .amax(dim=-1) + 2 * F32_UNIT_ROUNDOFF
    vmax = v64.abs().amax(dim=(1, 2))[:, None]
    bound = (2 * eta + 4 * SUM_LAMBDA * math.sqrt(3 * n) * F32_UNIT_ROUNDOFF + 2 * F32_UNIT_ROUNDOFF) * vmax
    err = (out_hnd.double() - ref).abs().amax(dim=-1)
    worst = (err / bound).max().item()
    check(worst <= 1.0, f"{tag}: attention against float64 at {worst:.3f} of its bound (max abs {err.max().item():.3e})")
    return worst, err.max().item()


def event_ms(fn, reps=3):
    """Median CUDA-event ms of ``reps`` calls of ``fn`` after one warm call, and the last result."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def layout_phase(dev, seed, smi):
    """[layout] on one card: ``moments_onepass`` and ``lloyd_fused`` at the row counts a ragged layout hands them
    (0, 1, 1023, 2^21 + 7 and the shard sizes of the path's maps of 2^26 rows over four cards) against their plain
    versions, with no launch and the neutral state at 0 rows; ``attention``, ``ring_attention`` and
    ``ulysses_attention`` at world size 1 on (H, N, D) = (8, 2^15, 128), full and causal, against float64 on
    ATT_SAMPLES query rows a head; ``SplitTiles``/``SquareDiagTiles`` reads and writes on the 2^24 x 32 blobs against
    numpy; ``reshape_via_flatmove`` and ``strided_take`` at world size 1."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import assign_stats, chunk_moments, lloyd_local, moments_local
    from heat_tpu_torch.parallel import flatmove

    ht.use_device("gpu")
    seed = seed + LAYOUT_SEED_OFFSET
    t_phase = time.perf_counter()
    # ---- the kernels at the row counts of ragged shards
    shards = sorted({c for kind in ("tail", "head", "empty") for c in layout_counts(N_LAYOUT_PATH,
                                                                                    layout_shares(4, kind))})
    rows = sorted(set(LAYOUT_ROWS) | set(shards))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cen = torch.randn(K_MAIN, F_MAIN, device=dev, generator=gen) * 8.0
    for n in rows:
        x = cen[torch.randint(0, K_MAIN, (n,), device=dev, generator=gen)] + torch.randn(n, F_MAIN, device=dev,
                                                                                          generator=gen)
        before = dict(ht.LAUNCHES)
        if n == 0:
            cnt, mean, m2 = moments_local(x)
            sums, counts, labels, inertia = lloyd_local(x, cen)
            torch.cuda.synchronize()
            check(dict(ht.LAUNCHES) == before, f"[layout] a launch at 0 rows: {before} -> {dict(ht.LAUNCHES)}")
            plain = chunk_moments(x), assign_stats(x, cen)
            check(float(cnt) == 0 and not bool(mean.abs().any() or m2.abs().any()) and not bool(sums.abs().any())
                  and not bool(counts.any()) and labels.numel() == 0 and float(inertia) == 0
                  and all(not bool(t.abs().any()) for t in (*plain[0], *plain[1][:2])),
                  "[layout] the wrappers at 0 rows should give the neutral state, as their plain versions do")
            print("[layout] n=0: moments_onepass and lloyd_fused launch nothing and return the merge's neutral state "
                  "(count 0, mean 0, M2 0; sums 0, counts 0, no labels, inertia 0), as their plain versions", flush=True)
            continue
        line_m = moments_vs_plain(f"[layout] n={n}", x)
        _, _, line_l = lloyd_vs_plain(f"[layout] n={n}", x, cen, n, expansion=True)
        launched = {k: v - before.get(k, 0) for k, v in ht.LAUNCHES.items() if v != before.get(k, 0)}
        check(launched == {"moments_onepass": 1, "lloyd_fused": 1}, f"[layout] n={n} launches {launched}")
        print(f"[layout] n={n}{' (a shard of the path)' if n in shards else ''}: {line_m}; {line_l}", flush=True)
        del x
    torch.cuda.empty_cache()

    # ---- the attentions at world size 1
    q_np, k_np, v_np = attention_qkv(seed, N_ATT_ONE)
    q, k, v = (torch.from_numpy(a).to(dev).transpose(0, 1).contiguous() for a in (q_np, k_np, v_np))  # (H, N, D)
    samples = np.random.default_rng(seed + 5).choice(N_ATT_ONE, ATT_SAMPLES, replace=False)
    samples.sort()
    qd, kd, vd = (ht.array(t, split=1) for t in (q, k, v))
    qu, ku, vu = (ht.array(torch.from_numpy(a).to(dev), split=0) for a in (q_np, k_np, v_np))
    lines = []
    for causal in (False, True):
        ms_ring, ring = event_ms(lambda: ht.parallel.ring_attention(qd, kd, vd, causal=causal))
        ms_uly, uly = event_ms(lambda: ht.parallel.ulysses_attention(qu, ku, vu, causal=causal))

        def dense():
            return torch.cat([ht.parallel.attention(q[h : h + 1], k[h : h + 1], v[h : h + 1], causal=causal)[:, samples]
                              for h in range(H_ATT)])

        ms_dense, dense_rows = event_ms(dense, reps=1)
        tag = f"[layout] {'causal' if causal else 'full'} attention (8, 2^15, 128)"
        w_ring, e_ring = attention_check(f"{tag} ring", ring.larray[:, samples], q, k, v, samples, causal)
        w_uly, e_uly = attention_check(f"{tag} ulysses", uly.larray[samples].transpose(0, 1), q, k, v, samples, causal)
        w_den, e_den = attention_check(f"{tag} dense", dense_rows, q, k, v, samples, causal)
        flop = 4 * H_ATT * N_ATT_ONE * N_ATT_ONE * D_ATT / (2 if causal else 1)
        lines.append(f"{tag}: ring_attention {ms_ring:.4f} ms, ulysses_attention {ms_uly:.4f} ms (CUDA events, median "
                     f"of 3), dense attention one head at a time {ms_dense:.4f} ms; float32 flop bound "
                     f"{4 * H_ATT * N_ATT_ONE * N_ATT_ONE * D_ATT / FP32_FLOP_PER_S * 1e3:.4f} ms "
                     f"({flop / 1e12:.3f} TFLOP of useful work); against float64 on {ATT_SAMPLES} rows a head: ring "
                     f"{e_ring:.3e} ({w_ring:.3f} of the bound), ulysses {e_uly:.3e} ({w_uly:.3f}), dense {e_den:.3e} "
                     f"({w_den:.3f})")
        del ring, uly
        torch.cuda.empty_cache()
    for line in lines:
        print(line, flush=True)
    del q, k, v, qd, kd, vd, qu, ku, vu
    torch.cuda.empty_cache()

    # ---- tiles, reshape and strided take on the 2^24 x 32 blobs
    x_np = layout_blobs(seed, N_MAIN, 0, N_MAIN)
    x = ht.array(x_np, split=0)
    t0 = time.perf_counter()
    tiles = ht.SplitTiles(x)
    check(np.array_equal(tiles[0, 0], x_np), "[layout] SplitTiles[0, 0]")
    tiles[0] = x_np[::-1].copy()
    check(np.array_equal(x.numpy(), x_np[::-1]), "[layout] SplitTiles[0] = ...")
    x = ht.array(x_np, split=0)
    sq = ht.tiling.SquareDiagTiles(x, ATT_TPP)
    edge = sq.row_indices[1]
    for key in ((3, 0), (slice(10, 12), 0), (sq.tile_rows - 1, 0)):
        lo = key[0].start * edge if isinstance(key[0], slice) else key[0] * edge
        hi = key[0].stop * edge if isinstance(key[0], slice) else min(lo + edge, N_MAIN)
        check(np.array_equal(sq[key], x_np[lo:hi]), f"[layout] SquareDiagTiles{key}")
        sq[key] = -x_np[lo:hi]
        x_np[lo:hi] = -x_np[lo:hi]
    check(np.array_equal(x.numpy(), x_np), "[layout] SquareDiagTiles writes")
    t_tiles = time.perf_counter() - t0
    comm = x.comm
    ms_rs, got = event_ms(lambda: flatmove.reshape_via_flatmove(x.larray, x.gshape, (N_MAIN // 2, 2 * F_MAIN), comm))
    check(torch.equal(got, x.larray.reshape(N_MAIN // 2, 2 * F_MAIN)), "[layout] reshape_via_flatmove")
    ms_st, (got, m) = event_ms(lambda: flatmove.strided_take(x.larray, 0, N_MAIN, 1, N_MAIN, 3, comm))
    check(m == len(range(1, N_MAIN, 3)) and torch.equal(got, x.larray[1::3]), "[layout] strided_take")
    print(f"[layout] SplitTiles (1 x 1 tiles at world size 1: the whole 2 GiB) and SquareDiagTiles({ATT_TPP} tiles a "
          f"process, {edge}-row tiles) reads and writes equal numpy ({t_tiles:.3f} s host, the host copies included); "
          f"reshape_via_flatmove (2^24, 32) -> (2^23, 64) {ms_rs:.4f} ms, strided_take [1::3] {ms_st:.4f} ms (CUDA "
          f"events, one card: local copies)", flush=True)
    print(f"[layout] phase {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)


# ---- [train]: the ML long tail and the training path on one card
TRAIN_SEED_OFFSET = 300      # [train]'s and [dist]'s training steps draw their numpy streams from --seed + this
N_GNB_MORE, N_GNB_PRED = 1 << 22, 1 << 20  # GaussianNB: a partial_fit chunk and held-out rows beside N_MAIN
GNB_SCALE = 4.0              # blob centres ~ N(0, 4^2); blob c's spread 0.5 + c / 8 per feature
GNB_ACC = 0.999
N_LASSO, F_LASSO = 10 ** 7, 64  # Heat's lasso protocol's ~1e7 rows, bench.py's 64 features, + the intercept
LASSO_LAM, LASSO_ITERS, LASSO_NOISE = 0.01, 100, 0.1
MNIST_N, MNIST_BATCH, MNIST_LR, MNIST_MOMENTUM = 60000, 256, 0.05, 0.9
MNIST_MEAN, MNIST_STD = 0.1307, 0.3081  # torchvision's MNIST normalization
DP_CHECK_STEPS = 20          # DataParallel held against a plain torch loop after this many steps
# DataParallel on one card against the plain loop on the same batches: the same operations in the same order, but
# cuDNN may pick another algorithm for one of two equal convolutions; float32 roundings of the products, amplified
# by 20 steps of SGD with momentum, stay orders of magnitude below 1e-4 of a parameter tensor's largest entry
DP_RTOL = 1e-4
# the attention gradients against float64: each is a float32 sum over N keys (or queries) of products of float32
# probabilities (each within a few u of exact) and float32 products of D terms; normwise, within 4 lambda sqrt(N) u
# of the float64 gradient (Higham and Mary's probabilistic bound, lambda = SUM_LAMBDA)
ATT_GRAD_RTOL = 4 * 8.0 * math.sqrt(1 << 15) * 2.0 ** -24
ATT_GRAD_BLOCK = 512         # query rows a block of the float64 reference


def mnist_files(root, seed, n=None):
    """Write MNIST-shaped IDX files (``train-images-idx3-ubyte``: n x 28 x 28 uint8; ``train-labels-idx1-ubyte``)
    under ``root``, made from ``seed``: noise in [0, 60) and, for class c, a bright 10 x 5 bar at a position of its
    own (rows 4 + 10 (c // 5), columns 1 + 5 (c % 5)). Returns (images, labels)."""
    import struct

    import numpy as np

    n = MNIST_N if n is None else n
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    images = rng.integers(0, 60, (n, 28, 28), dtype=np.uint8)
    for c in range(10):
        r, col = 4 + 10 * (c // 5), 1 + 5 * (c % 5)
        sel = labels == c
        images[sel, r : r + 10, col : col + 5] += rng.integers(150, 196, (int(sel.sum()), 10, 5), dtype=np.uint8)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, 3) + struct.pack(">III", n, 28, 28) + images.tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, 1) + struct.pack(">I", n) + labels.tobytes())
    return images, labels


def mnist_cnn():
    """The training path's CNN, of ``heat_tpu_torch.nn``'s torch-named layers (NCHW)."""
    import heat_tpu_torch as ht

    nn = ht.nn
    return nn.Sequential(nn.Conv2d(1, 32, 3), nn.ReLU(), nn.MaxPool2d(2), nn.Conv2d(32, 64, 3), nn.ReLU(),
                         nn.MaxPool2d(2), nn.Flatten(), nn.Linear(1600, 128), nn.ReLU(), nn.Linear(128, 10))


def mnist_loader(ht, root, split=0):
    """MNISTDataset -> Dataset (Normalize, then a channel axis), shuffled once from the random stream (the first
    epoch's order; the loader reshuffles after every later epoch) -> DataLoader (batch MNIST_BATCH). Seed the
    stream first: the same seed gives the same batches at every world size."""
    vt = ht.nn.vision_transforms
    ds = ht.utils.data.MNISTDataset(root, split=split)
    tf = vt.Compose([vt.Normalize((MNIST_MEAN,), (MNIST_STD,)), lambda t: t.unsqueeze(1)])
    dset = ht.utils.data.Dataset([ds.data, ds.targets], transforms=[tf, None])
    dset.shuffle()
    return ds, ht.utils.data.DataLoader(dset, batch_size=MNIST_BATCH)


def gnb_centres(ht):
    """GaussianNB's 8 blob centres, N(0, GNB_SCALE^2) draws of the random stream."""
    return (ht.random.randn(K_MAIN, F_MAIN) * GNB_SCALE).larray


def gnb_blobs(ht, n, centres):
    """GaussianNB's data: n rows x 32 of the 8 blobs at ``centres`` drawn with ht.random (split 0), blob c with
    spread 0.5 + c / 8 per feature; returns (x, labels)."""
    import torch

    member = ht.random.randint(0, K_MAIN, size=(n,), split=0, dtype=ht.int64)
    spread = 0.5 + torch.arange(K_MAIN, device=centres.device, dtype=torch.float32) / 8.0
    noise = ht.random.randn(n, F_MAIN, split=0)
    m = member.larray
    x = ht.DNDarray(noise.larray * spread[m][:, None] + centres[m], gshape=(n, F_MAIN), split=0)
    return x, member


def class_stats64(xs, ys, k):
    """float64 per-class counts, means, population variances and sums of |x| and x^2 over the (x, y) tensor pairs,
    in chunks of 2^22 rows."""
    import torch

    dev = xs[0].device
    cnt = torch.zeros(k, dtype=torch.float64, device=dev)
    s1 = torch.zeros(k, xs[0].shape[1], dtype=torch.float64, device=dev)
    s2, sa = torch.zeros_like(s1), torch.zeros_like(s1)
    for x, y in zip(xs, ys):
        for r0 in range(0, x.shape[0], 1 << 22):
            xc, yc = x[r0 : r0 + (1 << 22)].double(), y[r0 : r0 + (1 << 22)]
            oh = torch.nn.functional.one_hot(yc.long(), k).double()
            cnt += oh.sum(0)
            s1 += oh.T @ xc
            s2 += oh.T @ (xc * xc)
            sa += oh.T @ xc.abs()
    mean = s1 / cnt[:, None]
    return cnt, mean, s2 / cnt[:, None] - mean * mean, sa, s2


def lasso_cd64(X, y, lam, sweeps):
    """The port's coordinate descent (``regression/lasso.py``) in float64 for exactly ``sweeps`` sweeps; returns
    (theta, residual)."""
    import torch

    Xc = X.double().T.contiguous()
    r = y.double().clone()
    n, m = X.shape
    col_sq = (Xc * Xc).sum(1)
    theta = torch.zeros(m, dtype=torch.float64, device=X.device)
    thr = lam * n
    for _ in range(sweeps):
        for j in range(m):
            rho = torch.dot(Xc[j], r + Xc[j] * theta[j])
            new = rho if j == 0 else torch.sign(rho) * torch.clamp(rho.abs() - thr, min=0.0)
            new = new / col_sq[j]
            r -= Xc[j] * (new - theta[j])
            theta[j] = new
    return theta, r


def attention_grad64(q, k, v, dout, causal, block=ATT_GRAD_BLOCK):
    """Dense attention of (H, N, D) tensors and its gradients for the output gradient ``dout``, in float64, a block
    of query rows at a time (no (N, N) matrix held): (out, dq, dk, dv)."""
    import torch

    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    n, d = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    out, dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for a in range(0, n, block):
        qb, gb = q[:, a : a + block], dout[:, a : a + block]
        s = torch.matmul(qb, k.transpose(1, 2)) * scale
        if causal:
            rows = torch.arange(a, a + qb.shape[1], device=q.device)
            s = s.masked_fill(torch.arange(n, device=q.device)[None, None, :] > rows[None, :, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        ob = torch.matmul(p, v)
        dsum = (gb * ob).sum(-1, keepdim=True)
        ds = p * (torch.matmul(gb, v.transpose(1, 2)) - dsum)
        dv += torch.matmul(p.transpose(1, 2), gb)
        del p
        out[:, a : a + block] = ob
        dq[:, a : a + block] = torch.matmul(ds, k) * scale
        dk += torch.matmul(ds.transpose(1, 2), qb) * scale
        del ds
    return out, dq, dk, dv


def normwise(got, want):
    """Per head (axis 0), ||got - want||_F / ||want||_F; the largest."""
    g, w = got.double().reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    return ((g - w).norm(dim=1) / w.norm(dim=1)).max().item()


def daso_schedule_replay(losses, total, warmup, cooldown, max_skips, patience=2, threshold=0.05):
    """(global_skip, batches_to_wait, epoch) after each epoch_loss_logic call of ``losses``, by heat_tpu's rules
    written out here: warmup syncs every batch at once, cooldown every batch with skip 1; in between a loss that has
    not improved (relative threshold) for more than ``patience`` epochs halves the skip, or resets it to
    ``max_skips`` at skip 1."""
    skip, wait, epoch, best, bad, out = 4, 1, 0, float("inf"), 0, []
    for loss in losses:
        if epoch < warmup:
            skip, wait = 0, 0
        elif epoch >= total - cooldown:
            skip, wait = 1, 0
        else:
            wait = 1
            skip = 4 if skip == 0 else skip
            if loss < best * (1.0 - threshold):
                best, bad = loss, 0
            else:
                bad += 1
            if bad > patience:
                bad = 0
                skip = max_skips if skip <= 1 else skip // 2
        epoch += 1
        out.append((skip, wait, epoch))
    return out


def train_phase(dev, seed, smi):
    """[train] on one card: ``entry()``'s Lloyd step at 2^24 x 32 (one ``lloyd_fused`` launch) against the plain
    step; GaussianNB on 8 blobs of 2^24 x 32 (fit, a 2^22-row partial_fit, predict on 2^20 rows: its class
    statistics against float64 and against the path through the plain versions, accuracy, its ``moments_onepass``
    launches, the kernel on the path's own input); Lasso at 10^7 x 65 (the fit and 1-sweep fits, theta against the
    same coordinate descent in float64, sweeps/s against the bytes bound); one epoch of an MNIST-shaped CNN through
    MNISTDataset, DataLoader and DataParallel (the loss falls, 20 steps against a plain torch loop, a checkpoint
    round trip, step ms and images/s); ring and Ulysses attention backward at (8, 2^15, 128) against float64.
    Returns the phase's kernel launches."""
    import copy

    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch import entry as ht_entry
    from heat_tpu_torch.core.kernels import forced_mode

    ht.use_device("gpu")
    seed = seed + TRAIN_SEED_OFFSET
    t_phase = time.perf_counter()
    launches = {}

    def count(before):
        for k_, v_ in ht.LAUNCHES.items():
            launches[k_] = launches.get(k_, 0) + v_ - before.get(k_, 0)

    # ---- entry(): one Lloyd step at (2^24, 32), k = 8
    ht.random.seed(seed)
    centres = gnb_centres(ht)
    x, member = gnb_blobs(ht, N_MAIN, centres)
    xa = x.larray
    cen0 = xa[:K_MAIN].clone()
    fn, example = ht_entry.entry()
    check(tuple(fn(*example).shape) == (K_MAIN, F_MAIN), "[train] entry() on its example arguments")
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    new = fn(xa, cen0)
    torch.cuda.synchronize()
    check(dict(ht.LAUNCHES).get("lloyd_fused") == 1 and sum(ht.LAUNCHES.values()) == 1,
          f"[train] entry()'s step should launch lloyd_fused exactly once: {dict(ht.LAUNCHES)}")
    count({})
    with forced_mode("lloyd_fused", "torch"):
        new0 = fn(xa, cen0)
    cdiff = (new - new0).abs().max().item()
    check(cdiff <= CENTERS_RTOL * new0.abs().max().item(), f"[train] entry()'s step vs the plain step: {cdiff}")
    _, _, line_l = lloyd_vs_plain("[train] entry", xa, cen0, N_MAIN)
    ms_entry, _ = event_ms(lambda: fn(xa, cen0))
    ms_entry_plain, _ = event_ms(lambda: _plain(fn, xa, cen0), reps=1)
    print(f"[train] entry(): fn at ({N_MAIN}, {F_MAIN}), k = {K_MAIN}: 1 lloyd_fused launch; new centres vs the plain "
          f"step max abs {cdiff:.3e} (<= {CENTERS_RTOL} of max |c|); {line_l}; {ms_entry:.4f} ms (CUDA events, median "
          f"of 3), plain step {ms_entry_plain:.4f} ms", flush=True)

    # ---- GaussianNB: fit, partial_fit, predict
    x2, member2 = gnb_blobs(ht, N_GNB_MORE, centres)
    xq, member_q = gnb_blobs(ht, N_GNB_PRED, centres)
    line_m = moments_vs_plain("[train] gnb", xa)
    torch.cuda.synchronize()
    before = dict(ht.LAUNCHES)
    t0 = time.perf_counter()
    nb = ht.naive_bayes.GaussianNB().fit(x, member)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    nb.partial_fit(x2, member2)
    torch.cuda.synchronize()
    t_pfit = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = nb.predict(xq)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    gnb_launches = {k_: v_ - before.get(k_, 0) for k_, v_ in ht.LAUNCHES.items() if v_ != before.get(k_, 0)}
    count(before)
    check(gnb_launches == {"moments_onepass": 2}, f"[train] GaussianNB launches {gnb_launches}: one moments_onepass "
          f"for each fit's variance smoothing")
    acc = (pred.larray == member_q.larray).float().mean().item()
    check(acc >= GNB_ACC, f"[train] GaussianNB accuracy {acc}")
    cnt, mean64, var64, sabs, s2 = class_stats64([xa, x2.larray], [member.larray, member2.larray], K_MAIN)
    theta, sigma = nb.theta_.larray.double(), nb.sigma_.larray.double() - nb.epsilon_
    check(torch.equal(nb.class_count_.larray.double(), cnt), "[train] GaussianNB class counts")
    # the one-hot products add n_c float32 terms per class (within the accumulation bound), then a Welford merge of
    # two chunks (a few roundings of |mean|); the variance E[x^2] - mean^2 also carries mean^2's error
    b_mean = (accumulation_bound(N_MAIN, 1.0) * sabs / cnt[:, None] + 8 * F32_UNIT_ROUNDOFF * mean64.abs())
    b_var = (accumulation_bound(N_MAIN, 1.0) * s2 / cnt[:, None] + 2 * (mean64.abs() + b_mean) * b_mean
             + 8 * F32_UNIT_ROUNDOFF * (s2 / cnt[:, None]))
    w_mean = ((theta - mean64).abs() / b_mean).max().item()
    w_var = ((sigma - var64).abs() / b_var).max().item()
    check(w_mean <= 1.0 and w_var <= 1.0, f"[train] GaussianNB against float64: means {w_mean:.3f}, variances "
          f"{w_var:.3f} of their bounds")
    with forced_mode("moments_onepass", "torch"):
        nb0 = ht.naive_bayes.GaussianNB().fit(x, member)
        nb0.partial_fit(x2, member2)
    e_eps = abs(nb.epsilon_ - nb0.epsilon_) / nb0.epsilon_
    check(torch.equal(nb.theta_.larray, nb0.theta_.larray) and e_eps <= M2_RTOL, f"[train] GaussianNB vs the plain "
          f"path: theta equal, eps rel {e_eps}")
    e_sig = (nb.sigma_.larray - nb0.sigma_.larray).abs().max().item()
    check(e_sig <= 2 * abs(nb.epsilon_ - nb0.epsilon_) + 4 * F32_UNIT_ROUNDOFF * nb0.sigma_.larray.abs().max().item(),
          f"[train] GaussianNB sigma vs the plain path: {e_sig}")
    check(torch.equal(nb0.predict(xq).larray, pred.larray), "[train] GaussianNB predictions vs the plain path")
    print(f"[train] GaussianNB on {N_MAIN} x {F_MAIN} blobs (+ {N_GNB_MORE} by partial_fit, predict on {N_GNB_PRED}): "
          f"fit {t_fit:.4f} s, partial_fit {t_pfit:.4f} s, predict {t_pred:.4f} s (host, first calls); accuracy {acc:.5f}; "
          f"launches {gnb_launches}; against float64 means {w_mean:.3f}, variances {w_var:.3f} of their bounds; the "
          f"plain path's theta equal, eps rel {e_eps:.3e}, sigma max abs {e_sig:.3e}, predictions equal; {line_m}",
          flush=True)
    del x, member, x2, member2, xq, member_q, xa, nb, nb0, pred, new, new0
    torch.cuda.empty_cache()

    # ---- Lasso at 10^7 x 65
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    X = torch.empty(N_LASSO, F_LASSO + 1, device=dev)
    X[:, 0] = 1.0
    X[:, 1:] = torch.randn(N_LASSO, F_LASSO, device=dev, generator=gen)
    coef = torch.randn(F_LASSO + 1, device=dev, generator=gen) * (torch.rand(F_LASSO + 1, device=dev,
                                                                             generator=gen) < 0.25)
    coef[0] = 1.5
    y = X @ coef + LASSO_NOISE * torch.randn(N_LASSO, device=dev, generator=gen)
    xd, yd = ht.array(X, split=0, copy=False), ht.array(y, split=0, copy=False)
    torch.cuda.synchronize()
    before = dict(ht.LAUNCHES)
    t0 = time.perf_counter()
    las = ht.regression.Lasso(lam=LASSO_LAM, max_iter=LASSO_ITERS).fit(xd, yd)
    torch.cuda.synchronize()
    t_las = time.perf_counter() - t0
    check(dict(ht.LAUNCHES) == before, "[train] Lasso launches no kernel of the TPU's")
    one_ms = event_ms(lambda: ht.regression.Lasso(lam=LASSO_LAM, max_iter=1).fit(xd, yd), reps=3)[0]
    theta = las.theta.larray.reshape(-1).double()
    th64, r64 = lasso_cd64(X, y, LASSO_LAM, las.n_iter)
    # each rho is a float32 sum of n products x_ij (r_i + x_ij theta_j) (within the accumulation bound of
    # B_j = sum_i |x_ij| (|r_i| + |x_ij theta_j|)), divided by ||x_j||^2: per sweep, per coordinate; 2 n_iter sweeps'
    # worth bounds what the sweeps carry forward
    X64abs_r = torch.zeros(F_LASSO + 1, dtype=torch.float64, device=dev)
    col_sq = torch.zeros_like(X64abs_r)
    for r0 in range(0, N_LASSO, 1 << 22):
        xc = X[r0 : r0 + (1 << 22)].double()
        X64abs_r += xc.abs().T @ r64[r0 : r0 + (1 << 22)].abs()
        col_sq += (xc * xc).sum(0)
    b_theta = 2 * las.n_iter * accumulation_bound(N_LASSO, 1.0) * (X64abs_r + th64.abs() * col_sq) / col_sq
    w_theta = ((theta - th64).abs() / b_theta).max().item()
    check(w_theta <= 1.0, f"[train] Lasso theta against float64 coordinate descent: {w_theta:.3f} of the bound")
    e_true = (theta - coef.double()).abs().max().item()
    check(e_true <= 0.05, f"[train] Lasso theta against the generating coefficients: {e_true}")
    sweep_bound = 2 * N_LASSO * (F_LASSO + 1) * 4 / HBM_BYTES_PER_S * 1e3
    print(f"[train] Lasso(lam={LASSO_LAM}, max_iter={LASSO_ITERS}) on {N_LASSO} x {F_LASSO + 1}: {las.n_iter} sweeps "
          f"in {t_las:.4f} s host ({las.n_iter / t_las:.2f} sweeps/s, the column-major copy included); a 1-sweep fit "
          f"{one_ms:.4f} ms (CUDA events, median of 3: copy, column norms and one sweep); bound "
          f"2 n (f + 1) 4 B / 3.35 TB/s = {sweep_bound:.4f} ms a sweep; theta vs float64 coordinate descent of "
          f"{las.n_iter} sweeps max abs {(theta - th64).abs().max().item():.3e} ({w_theta:.3f} of the bound), vs the "
          f"generating coefficients {e_true:.3e}", flush=True)
    del X, y, xd, yd, las, th64, r64
    torch.cuda.empty_cache()

    # ---- training: MNIST-shaped IDX files -> MNISTDataset -> DataLoader -> DataParallel(CNN)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        images, labels = mnist_files(tmp, seed)
        ht.random.seed(seed)
        ds, loader = mnist_loader(ht, tmp)
        vt = ht.nn.vision_transforms
        check(torch.equal(vt.ToTensor()(images[0]).to(dev), ds.data.larray[0])
              and torch.equal(ds.targets.larray.cpu(), torch.as_tensor(labels.astype(np.int64))),
              "[train] MNISTDataset against ToTensor of the IDX images and the labels")
        torch.manual_seed(seed)
        model = mnist_cnn().to(dev)
        init_state = copy.deepcopy(model.state_dict())
        dp = ht.nn.DataParallel(model, optimizer=torch.optim.SGD(model.parameters(), lr=MNIST_LR,
                                                                 momentum=MNIST_MOMENTUM))
        ce = ht.nn.CrossEntropyLoss()
        losses, snap = [], None
        torch.cuda.synchronize()
        before = dict(ht.LAUNCHES)
        t0 = time.perf_counter()
        for step, (xb, yb) in enumerate(loader):
            losses.append(dp.train_step(ce, xb, yb))
            if step == 0:
                torch.cuda.synchronize()
                t_first = time.perf_counter() - t0
            if step == DP_CHECK_STEPS - 1:
                snap = {k_: v_.detach().clone() for k_, v_ in model.state_dict().items()}
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        check(dict(ht.LAUNCHES) == before, "[train] the training loop launches no kernel of the TPU's")
        steps = len(losses)
        lv = torch.stack(losses).cpu()
        first, last = lv[:10].mean().item(), lv[-10:].mean().item()
        check(steps == MNIST_N // MNIST_BATCH and last < 0.5 * first, f"[train] {steps} steps, loss {first} -> {last}")
        # the plain loop: the same initialization, the same first batches (the same seed, the same shuffle)
        plain = mnist_cnn().to(dev)
        plain.load_state_dict(init_state)
        popt = torch.optim.SGD(plain.parameters(), lr=MNIST_LR, momentum=MNIST_MOMENTUM)
        ht.random.seed(seed)
        _, loader0 = mnist_loader(ht, tmp)
        for step, (xb, yb) in enumerate(loader0):
            if step == DP_CHECK_STEPS:
                break
            popt.zero_grad()
            ce(plain(xb.larray), yb.larray).backward()
            popt.step()
        worst, identical = 0.0, True
        for k_, v_ in plain.state_dict().items():
            e = (snap[k_].double() - v_.double()).abs().max().item()
            identical = identical and torch.equal(snap[k_], v_)
            worst = max(worst, e / max(v_.abs().max().item(), 1e-30))
        check(worst <= DP_RTOL, f"[train] DataParallel after {DP_CHECK_STEPS} steps vs the plain loop: {worst}")
        # a checkpoint round trip, bit for bit
        state = {"model": model.state_dict(), "optimizer": {k_: v_ for k_, v_ in dp.state_dict().items()
                                                             if k_.startswith("opt.")}}
        ht.utils.save_checkpoint(os.path.join(tmp, "ckpt"), state, step=steps, metadata={"phase": "train"})
        like = {"model": copy.deepcopy(init_state), "optimizer": {k_: np.zeros_like(v_) for k_, v_ in
                                                                   state["optimizer"].items()}}
        got, got_step, meta = ht.utils.load_checkpoint(os.path.join(tmp, "ckpt"), like=like)
        check(got_step == steps and meta == {"phase": "train"}
              and all(torch.equal(got["model"][k_], v_) for k_, v_ in state["model"].items())
              and all(np.array_equal(got["optimizer"][k_], v_) for k_, v_ in state["optimizer"].items()),
              "[train] checkpoint round trip")
        step_ms = (t_epoch - t_first) / (steps - 1) * 1e3
        print(f"[train] one epoch of the CNN on {MNIST_N} MNIST-shaped images (IDX files written from the seed), "
              f"MNISTDataset -> DataLoader({MNIST_BATCH}, shuffled) -> DataParallel, SGD momentum {MNIST_MOMENTUM}: {steps} "
              f"steps in {t_epoch:.4f} s (first step {t_first * 1e3:.2f} ms; then {step_ms:.4f} ms a step, "
              f"{MNIST_BATCH / step_ms * 1e3:.0f} images/s); loss {first:.4f} (first 10 steps) -> {last:.4f} (last 10); "
              f"after {DP_CHECK_STEPS} steps against the plain torch loop: max rel {worst:.3e} (bit-identical: "
              f"{identical}); checkpoint of {len(state['model'])} + {len(state['optimizer'])} tensors round-trips bit "
              f"for bit", flush=True)
        del model, plain, dp, ds, loader, loader0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the attention gradients at world size 1
    q_np, k_np, v_np = attention_qkv(seed, N_ATT_ONE)
    q, k, v = (torch.from_numpy(a).to(dev).transpose(0, 1).contiguous() for a in (q_np, k_np, v_np))  # (H, N, D)
    dout = torch.randn(q.shape, device=dev, generator=gen)
    lines = []
    for causal in (False, True):
        ref = attention_grad64(q, k, v, dout, causal)

        def ring_bw():
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = ht.parallel.ring_attention(*(ht.DNDarray(t, split=1) for t in ts), causal=causal)
            (o.larray * dout).sum().backward()
            return [o.larray.detach()] + [t.grad for t in ts]

        def ulysses_bw():
            ts = [t.transpose(0, 1).contiguous().requires_grad_(True) for t in (q, k, v)]
            o = ht.parallel.ulysses_attention(*(ht.DNDarray(t, split=0) for t in ts), causal=causal)
            (o.larray * dout.transpose(0, 1)).sum().backward()
            return [o.larray.detach().transpose(0, 1)] + [t.grad.transpose(0, 1) for t in ts]

        for name, fn_bw in (("ring", ring_bw), ("ulysses", ulysses_bw)):
            ms, res = event_ms(fn_bw, reps=2)
            errs = [normwise(g, r) for g, r in zip(res, ref)]
            check(max(errs) <= ATT_GRAD_RTOL, f"[train] {name} attention ({'causal' if causal else 'full'}) gradients "
                  f"against float64: {errs} (normwise, <= {ATT_GRAD_RTOL:.3e})")
            lines.append(f"{name} {'causal' if causal else 'full'}: forward + backward {ms:.4f} ms (CUDA events, median "
                         f"of 2); out, dq, dk, dv against float64 normwise " + ", ".join(f"{e:.3e}" for e in errs))
            del res
        del ref
        torch.cuda.empty_cache()
    print(f"[train] attention gradients at (8, 2^15, 128), world size 1 (<= {ATT_GRAD_RTOL:.3e}): " + "; ".join(lines),
          flush=True)
    del q, k, v, dout
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[train] phase {wall:.1f} s ({smi}); launches {launches}", flush=True)
    return launches


def _plain(fn, xa, cen):
    """``fn(xa, cen)`` through ``lloyd_fused``'s plain version."""
    from heat_tpu_torch.core.kernels import forced_mode

    with forced_mode("lloyd_fused", "torch"):
        return fn(xa, cen)


LASSO_DIST_ITERS = 20  # [dist]'s Lasso: a fixed number of sweeps (tol 0), so that every world size runs as many
DASO_DIST_BATCHES = 8  # [dist]'s DASO: batches of the MNIST epoch with a sync every 2


def _param_digest(model):
    """An integer digest of every parameter's bits (equal digests: bit-identical parameters, barring a collision)."""
    import torch

    bits = torch.cat([p.detach().reshape(-1).view(torch.int32).to(torch.int64) for p in model.parameters()])
    w = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64) % 1000003 + 1
    return (bits * w).sum().reshape(1)


def _lasso_chunk(seed, rank, n, dev):
    """Rank ``rank``'s rows of [dist]'s Lasso data (its own stream) and the generating coefficients."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    coef = torch.randn(F_LASSO + 1, device=dev, generator=g) * (torch.rand(F_LASSO + 1, device=dev, generator=g) < 0.25)
    coef[0] = 1.5
    g.manual_seed(seed * 1000 + rank + 1)
    X = torch.empty(n, F_LASSO + 1, device=dev)
    X[:, 0] = 1.0
    X[:, 1:] = torch.randn(n, F_LASSO, device=dev, generator=g)
    y = X @ coef + LASSO_NOISE * torch.randn(n, device=dev, generator=g)
    return X, y, coef


def _dist_train(ht, world, rank, timed, same_everywhere, say, out_dir, seed):
    """[dist]'s training path on this rank: DataParallel over the MNIST epoch (parameters bit-identical on every
    rank after every step), DASO's diverge-and-meet on a (2 x P/2) mesh and its schedule against a host replay (at
    an even world size >= 4), GaussianNB at 2^24 x 32 rows and Lasso at 10^7 rows a card (split 0), the ring and
    Ulysses gradients against float64, and the entry module's dry-run body. Returns what the parent compares."""
    import numpy as np
    import torch

    from heat_tpu_torch.entry import dryrun_body

    comm = ht.get_comm()
    dev = ht.get_device().torch_device
    seed = seed + TRAIN_SEED_OFFSET
    out, steps_t = {}, {}

    # ---- DataParallel over the epoch, the global batches split by rank
    ht.random.seed(seed)
    ds, loader = mnist_loader(ht, os.path.join(out_dir, "mnist"))
    torch.manual_seed(seed)
    model = mnist_cnn().to(dev)
    dp = ht.nn.DataParallel(model, optimizer=torch.optim.SGD(model.parameters(), lr=MNIST_LR, momentum=MNIST_MOMENTUM))
    ce = ht.nn.CrossEntropyLoss()
    losses, digests = [], []
    ht.kernels.reset_kernel_stats()
    torch.cuda.synchronize()
    comm.barrier()
    t0 = time.perf_counter()
    for step, (xb, yb) in enumerate(loader):
        losses.append(dp.train_step(ce, xb, yb))
        digests.append(_param_digest(model))
        if step == DP_CHECK_STEPS - 1:
            out["dp_snapshot"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    t_epoch = time.perf_counter() - t0
    coll = {k: v["calls"] for k, v in ht.kernels.COLLECTIVES.items()}
    d = torch.cat(digests)
    every = comm.allgather(d.unsqueeze(0), 0, [1] * world)
    check(bool((every == every[0]).all()), "[dist] DataParallel parameters differ between ranks after some step")
    lv = torch.stack(losses).cpu()
    steps = len(losses)
    check(lv[-10:].mean() < 0.5 * lv[:10].mean(), f"[dist] DataParallel loss {lv[:10].mean()} -> {lv[-10:].mean()}")
    steps_t["DataParallel epoch"] = {"host_s": t_epoch, "event_ms": float("nan"), "collectives": coll}
    out["dp"] = {"steps": steps, "t_epoch": t_epoch, "loss": (lv[:10].mean().item(), lv[-10:].mean().item()),
                 "rows": xb.lshape[0]}
    say(f"DataParallel: {steps} steps of {MNIST_BATCH} global rows ({xb.lshape[0]} on this rank in the last batch) in "
        f"{t_epoch:.4f} s ({t_epoch / steps * 1e3:.4f} ms a step, {MNIST_BATCH * steps / t_epoch:.0f} images/s over "
        f"{world} card(s)); parameters bit-identical on every rank after each of the {steps} steps; loss "
        f"{out['dp']['loss'][0]:.4f} -> {out['dp']['loss'][1]:.4f}; COLLECTIVES {coll}")
    del dp, ds, loader
    torch.cuda.empty_cache()

    # ---- DASO: replicas diverge between syncs and meet at them; the schedule against a host replay
    if world >= 4 and world % 2 == 0:
        ht.random.seed(seed)
        _, loader = mnist_loader(ht, os.path.join(out_dir, "mnist"))
        torch.manual_seed(seed)
        net = mnist_cnn().to(dev)
        mesh = ht.parallel.make_hierarchical_mesh(n_slow=2)
        daso = ht.optim.DASO(torch.optim.SGD(net.parameters(), lr=MNIST_LR), total_epochs=4, warmup_epochs=0,
                             cooldown_epochs=0)
        net = daso.init(net, mesh)
        daso.epoch, daso.global_skip, daso.batches_to_wait = 1, 2, 0  # a sync every 2 batches, applied at once
        gaps = []
        t0 = time.perf_counter()
        for b, (xb, yb) in enumerate(loader):
            if b == DASO_DIST_BATCHES:
                break
            net, _ = daso.step(lambda m, xx, yy: ce(m(xx), yy), net, xb, yb)
            w = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
            gaps.append(float(ht.nn.data_parallel.group_allreduce(w * (1.0 if daso._group == 0 else -1.0),
                                                                   daso._slow).abs().max()))
        t_daso = time.perf_counter() - t0
        check(all(g == 0.0 for g in gaps[0::2]) and all(g > 0.0 for g in gaps[1::2]),
              f"[dist] DASO replicas must meet at the syncs (even batches) and diverge between them: {gaps}")
        losses = [1.0, 0.9, 0.8, 0.79, 0.789, 0.7885, 0.788, 0.6, 0.59, 0.5899, 0.58985, 0.5898]
        sched = ht.optim.DASO(torch.optim.SGD(net.parameters(), lr=MNIST_LR), total_epochs=len(losses),
                              warmup_epochs=2, cooldown_epochs=2, max_global_skips=8)
        sched.init(net, mesh)
        fields = []
        for loss in losses:
            sched.epoch_loss_logic(loss)
            fields.append((sched.global_skip, sched.batches_to_wait, sched.epoch))
        replay = daso_schedule_replay(losses, len(losses), 2, 2, 8)
        check(fields == replay, f"[dist] DASO schedule {fields} against the host replay {replay}")
        out["daso"] = {"gaps": gaps, "t": t_daso, "fields": fields}
        say(f"DASO on a (2 x {world // 2}) mesh, {DASO_DIST_BATCHES} batches, a sync every 2: replica gaps "
            f"{[f'{g:.3e}' for g in gaps]} (0 at the syncs) in {t_daso:.4f} s; schedule fields equal the host replay "
            f"over {len(losses)} epochs: {fields}")
        del net, daso, sched, loader
        torch.cuda.empty_cache()

    # ---- GaussianNB at 2^24 x 32 rows a card
    ht.random.seed(seed)
    x, member = gnb_blobs(ht, N_MAIN * world, gnb_centres(ht))
    ht.kernels.reset_kernel_stats()
    nb, t_nb, ev_nb = timed(lambda: ht.naive_bayes.GaussianNB().fit(x, member))
    coll = timed.collectives
    check({k: v["calls"] for k, v in coll.items()} == ({"allgather": 2, "allreduce": 3} if world > 1 else {}),
          f"[dist] GaussianNB fit collectives {coll}")
    check(dict(ht.LAUNCHES).get("moments_onepass") == 1, f"[dist] GaussianNB launches {dict(ht.LAUNCHES)}")
    for name in ("theta_", "sigma_", "class_count_"):
        same_everywhere(getattr(nb, name).larray, f"GaussianNB {name}")
    out["gnb"] = {"theta": nb.theta_.larray.cpu(), "sigma": nb.sigma_.larray.cpu(), "eps": nb.epsilon_,
                  "count": nb.class_count_.larray.cpu()}
    steps_t["GaussianNB fit"] = {"host_s": t_nb, "event_ms": ev_nb, "collectives": coll}
    say(f"GaussianNB fit of {N_MAIN * world} x {F_MAIN} (split 0): {t_nb:.4f} s host, {ev_nb:.4f} ms events, "
        f"COLLECTIVES {coll}")
    del x, member, nb
    torch.cuda.empty_cache()

    # ---- Lasso at 10^7 rows a card
    X, y, _ = _lasso_chunk(seed, rank, N_LASSO, dev)
    xd = ht.DNDarray(X, gshape=(N_LASSO * world, F_LASSO + 1), split=0)
    yd = ht.DNDarray(y, gshape=(N_LASSO * world,), split=0)
    las, t_las, ev_las = timed(lambda: ht.regression.Lasso(lam=LASSO_LAM, max_iter=LASSO_DIST_ITERS, tol=0.0)
                               .fit(xd, yd))
    coll = timed.collectives
    want = {"allreduce": 1 + (F_LASSO + 1) * LASSO_DIST_ITERS} if world > 1 else {}
    check({k: v["calls"] for k, v in coll.items()} == want and las.n_iter == LASSO_DIST_ITERS,
          f"[dist] Lasso collectives {coll}, sweeps {las.n_iter}")
    same_everywhere(las.theta.larray, "Lasso theta")
    out["lasso"] = {"theta": las.theta.larray.cpu()}
    steps_t["Lasso fit"] = {"host_s": t_las, "event_ms": ev_las, "collectives": coll}
    say(f"Lasso fit of {N_LASSO * world} x {F_LASSO + 1}, {LASSO_DIST_ITERS} sweeps: {t_las:.4f} s host "
        f"({LASSO_DIST_ITERS / t_las:.2f} sweeps/s), {ev_las:.4f} ms events; one scalar allreduce per coordinate: "
        f"COLLECTIVES {coll}")
    del X, y, xd, yd, las
    torch.cuda.empty_cache()

    # ---- ring and Ulysses gradients against float64, the sequence split over the cards
    n = N_ATT_CARD * world
    off, lsh, _ = comm.chunk((n,), 0)
    q_np, k_np, v_np = attention_qkv(seed, n)
    g_np = attention_qkv(seed + 50, n)[0]
    full = [torch.from_numpy(a).to(dev).transpose(0, 1).contiguous() for a in (q_np, k_np, v_np, g_np)]  # (H, N, D)
    att = {}
    for causal in (False, True):
        ref = attention_grad64(*full, causal)
        for name in ("ring", "ulysses"):
            if name == "ring":
                ts = [t[:, off : off + lsh[0]].clone().requires_grad_(True) for t in full[:3]]
                args = [ht.DNDarray(t, gshape=(H_ATT, n, D_ATT), split=1) for t in ts]
                fn, gl = ht.parallel.ring_attention, full[3][:, off : off + lsh[0]]
            else:
                ts = [t[:, off : off + lsh[0]].transpose(0, 1).contiguous().requires_grad_(True) for t in full[:3]]
                args = [ht.DNDarray(t, gshape=(n, H_ATT, D_ATT), split=0) for t in ts]
                fn, gl = ht.parallel.ulysses_attention, full[3][:, off : off + lsh[0]].transpose(0, 1)
            ht.kernels.reset_kernel_stats()
            o, _, ev_att = timed(lambda: fn(*args, causal=causal))
            _, t_bw, ev_bw = timed(lambda: (o.larray * gl).sum().backward())
            bw_coll = timed.collectives
            grads = [t.grad if name == "ring" else t.grad.transpose(0, 1) for t in ts]
            outs = [o.larray.detach() if name == "ring" else o.larray.detach().transpose(0, 1)] + grads
            errs = [normwise(g, r[:, off : off + lsh[0]]) for g, r in zip(outs, ref)]
            check(max(errs) <= ATT_GRAD_RTOL, f"[dist] {name} ({'causal' if causal else 'full'}) gradients against "
                  f"float64: {errs}")
            want = {"ring_shift": {"calls": 2 * (world - 1)}} if name == "ring" else {"alltoall": {"calls": 2}}
            if world > 1:
                check({k: {"calls": v["calls"]} for k, v in bw_coll.items()} == want,
                      f"[dist] {name} backward collectives {bw_coll}")
            att[f"{name} {'causal' if causal else 'full'}"] = {"fwd_ms": ev_att, "bwd_ms": ev_bw, "errs": errs,
                                                               "bwd_collectives": bw_coll}
            steps_t[f"{name} {'causal' if causal else 'full'} backward"] = {"host_s": t_bw, "event_ms": ev_bw,
                                                                           "collectives": bw_coll}
            del o, grads, outs, ts, args
        del ref
        torch.cuda.empty_cache()
    out["attention"] = att
    say("attention gradients (8, " + str(n) + ", 128), " + str(lsh[0]) + " of the sequence a card: " + "; ".join(
        f"{k} forward {v['fwd_ms']:.4f} ms, backward {v['bwd_ms']:.4f} ms, against float64 normwise "
        + ", ".join(f"{e:.3e}" for e in v["errs"]) + f", backward COLLECTIVES {v['bwd_collectives']}"
        for k, v in att.items()))
    del full
    torch.cuda.empty_cache()

    # ---- the entry module's dry-run body
    res, t_dry, _ = timed(lambda: dryrun_body(ht))
    out["dryrun"] = {"t": t_dry, "qr_residual": res["qr_residual"], "daso_gaps": res.get("daso_gaps")}
    steps_t["dryrun body"] = {"host_s": t_dry, "event_ms": float("nan"), "collectives": timed.collectives}
    say(f"entry.dryrun_body: every check passed in {t_dry:.4f} s (TSQR residual {res['qr_residual']:.3e}"
        + (f", DASO gaps {[f'{g:.3e}' for g in res['daso_gaps']]}" if "daso_gaps" in res else "") + ")")
    out["steps"] = steps_t
    return out


def _train_reference(ht, world, ranks, tmp, seed):
    """[dist]'s training steps in this process on the same global data: DataParallel's 20 steps on the global
    batches against rank 0's, GaussianNB against the ranks' fit, Lasso against the ranks' theta."""
    import copy

    import numpy as np
    import torch

    dev = ht.get_device().torch_device
    seed = seed + TRAIN_SEED_OFFSET
    tr = [r["train"] for r in ranks]
    # DataParallel: the first 20 global batches in one process
    ht.random.seed(seed)
    _, loader = mnist_loader(ht, os.path.join(tmp, "mnist"))
    torch.manual_seed(seed)
    model = mnist_cnn().to(dev)
    dp = ht.nn.DataParallel(model, optimizer=torch.optim.SGD(model.parameters(), lr=MNIST_LR, momentum=MNIST_MOMENTUM))
    ce = ht.nn.CrossEntropyLoss()
    for step, (xb, yb) in enumerate(loader):
        if step == DP_CHECK_STEPS:
            break
        dp.train_step(ce, xb, yb)
    worst = 0.0
    for k, v in model.state_dict().items():
        e = (tr[0]["dp_snapshot"][k].to(dev).double() - v.double()).abs().max().item()
        worst = max(worst, e / max(v.abs().max().item(), 1e-30))
    check(worst <= DP_RTOL, f"[dist] DataParallel after {DP_CHECK_STEPS} steps vs one card on the global batches: "
          f"{worst}")
    del dp, model, loader
    # GaussianNB: one process on the same global data, both against float64
    ht.random.seed(seed)
    x, member = gnb_blobs(ht, N_MAIN * world, gnb_centres(ht))
    nb = ht.naive_bayes.GaussianNB().fit(x, member)
    cnt, mean64, var64, sabs, s2 = class_stats64([x.larray], [member.larray], K_MAIN)
    b_mean = accumulation_bound(N_MAIN * world, 1.0) * sabs / cnt[:, None] + 8 * F32_UNIT_ROUNDOFF * mean64.abs()
    b_var = (accumulation_bound(N_MAIN * world, 1.0) * s2 / cnt[:, None] + 2 * (mean64.abs() + b_mean) * b_mean
             + 8 * F32_UNIT_ROUNDOFF * (s2 / cnt[:, None]))
    g = tr[0]["gnb"]
    w_mean = max(((t.to(dev).double() - mean64).abs() / b_mean).max().item() for t in (g["theta"], nb.theta_.larray))
    w_var = max(((t.to(dev).double() - e - var64).abs() / b_var).max().item()
                for t, e in ((g["sigma"], g["eps"]), (nb.sigma_.larray, nb.epsilon_)))
    check(torch.equal(g["count"].to(dev), nb.class_count_.larray) and w_mean <= 1.0 and w_var <= 1.0,
          f"[dist] GaussianNB: the ranks' and one process's means {w_mean:.3f}, variances {w_var:.3f} of their float64 "
          f"bounds")
    del x, member, nb
    torch.cuda.empty_cache()
    # Lasso: one process on the ranks' rows
    parts = [_lasso_chunk(seed, r, N_LASSO, dev) for r in range(world)]
    X = torch.cat([p[0] for p in parts])
    y = torch.cat([p[1] for p in parts])
    del parts
    torch.cuda.empty_cache()
    las = ht.regression.Lasso(lam=LASSO_LAM, max_iter=LASSO_DIST_ITERS, tol=0.0).fit(ht.array(X, split=0, copy=False),
                                                                                    ht.array(y, split=0, copy=False))
    theta1 = las.theta.larray.reshape(-1).double()
    thetaP = tr[0]["lasso"]["theta"].to(dev).reshape(-1).double()
    absr = torch.zeros(F_LASSO + 1, dtype=torch.float64, device=dev)
    col_sq = torch.zeros_like(absr)
    r = y.double() - X.double() @ theta1 if X.numel() * 8 < (16 << 30) else None
    for r0 in range(0, X.shape[0], 1 << 22):
        xc = X[r0 : r0 + (1 << 22)].double()
        rc = (y[r0 : r0 + (1 << 22)].double() - xc @ theta1) if r is None else r[r0 : r0 + (1 << 22)]
        absr += xc.abs().T @ rc.abs()
        col_sq += (xc * xc).sum(0)
    bound = 4 * LASSO_DIST_ITERS * accumulation_bound(X.shape[0], 1.0) * (absr + theta1.abs() * col_sq) / col_sq
    w_las = ((thetaP - theta1).abs() / bound).max().item()
    check(w_las <= 1.0, f"[dist] Lasso theta vs one process: {w_las:.3f} of the bound")
    print(f"[dist] train vs one process on the same global data: DataParallel after {DP_CHECK_STEPS} steps max rel "
          f"{worst:.3e} (<= {DP_RTOL}); GaussianNB means {w_mean:.3f}, variances {w_var:.3f} of their float64 bounds "
          f"(ranks' and one process's), counts equal; Lasso theta max abs {(thetaP - theta1).abs().max().item():.3e} "
          f"({w_las:.3f} of the bound)", flush=True)
    return {"dp_worst": worst, "gnb": (w_mean, w_var), "lasso": w_las}


# ---- [frame] and [resilience]: the relational layer on TPC-H data, checkpoints and guards
FRAME_SEED_OFFSET = 400        # [frame]'s, [resilience]'s and [dist]'s frame steps draw from --seed + this
TPCH_ORDERS = 15_000_000       # TPC-H v3.0.1 §4.2.3 at scale factor 10: 1.5e6 orders per SF
TPCH_PARTS = 2_000_000         # 200000 parts per SF: P_PARTKEY's range, whose P_RETAILPRICE prices a line
TPCH_DROP = 100                # the left join's orders lack every 100th order
FRAME_SPEC = ["sum", "mean", "min", "max", "std", "count"]
FRAME_VALUES = ("l_quantity", "l_extendedprice", "l_discount")  # the groupby's value columns (float32)
STREAM_GB_CHUNKS, STREAM_GB_CAPACITY = 8, 1 << 24
QUANTILE_K, QUANTILE_LEVELS = 256, 8  # FrameGroupBy.quantile's defaults
# a sum of m float32 terms in the order the runs hold them: |err| <= m u sum|x| (gamma_m, m u < 1); the orderkey
# groups hold at most 7 rows, the rest is SUM_LAMBDA's bound (accumulation_bound)
TPCH_MAX_LINES = 7
# the groupby's std is sqrt(max(0, (S2/n - mean^2) n/(n-1))) in float32: the difference of S2/n and mean^2 (each
# within (m + 3) u of its value, m <= 7 terms) loses up to STD_ROUNDINGS u (S2/n + mean^2) n/(n-1) of the variance,
# and |sqrt(a) - sqrt(b)| <= sqrt(|a - b|): the std is held within sqrt of that
STD_ROUNDINGS = 2 * (TPCH_MAX_LINES + 3) + 2
CKPT_SMALL = 1 << 20           # rows of the 2^24 x 32 blobs in the torn-write and corruption checks
STRAGGLER_DEADLINE, STRAGGLER_DELAY = 0.5, 2.0  # the watchdog's deadline and the injected straggler's sleep (s)
N_DIST_CKPT = 1 << 20          # [dist]'s checkpoint: rows of 32 float32 per card


@functools.lru_cache(maxsize=1)  # [resilience] checkpoints the lineitem [frame] made in the same process
def tpch_sf10(seed):
    """TPC-H's ``orders`` and ``lineitem`` at SF 10 with numpy from ``seed``, to v3.0.1 §4.2.3's distributions
    (no dbgen): O_ORDERKEY sparse as dbgen makes it (the first 8 keys of every 32), 1 to 7 lines an order (uniform),
    L_QUANTITY uniform in 1..50, L_EXTENDEDPRICE = quantity x P_RETAILPRICE of a uniform part
    ((90000 + (partkey/10) mod 20001 + 100 (partkey mod 1000)) / 100, in [901, 2100]), L_DISCOUNT uniform in
    {0.00, ..., 0.10}, L_TAX in {0.00, ..., 0.08}, O_TOTALPRICE the sum of its lines' extendedprice (1 + tax)
    (1 - discount). Returns (lines per order, lineitem columns, orders columns); lineitem is in orderkey order, the
    numeric columns float32 plus an int32 copy of the quantity."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i = np.arange(TPCH_ORDERS, dtype=np.int32)
    o_orderkey = (i // 8) * 32 + i % 8 + 1
    lines = rng.integers(1, TPCH_MAX_LINES + 1, size=TPCH_ORDERS, dtype=np.int32)
    n = int(lines.sum())
    qty = rng.integers(1, 51, size=n, dtype=np.int32)
    part = rng.integers(1, TPCH_PARTS + 1, size=n, dtype=np.int32)
    cents = 90000 + (part // 10) % 20001 + 100 * (part % 1000)  # P_RETAILPRICE in cents
    del part
    price = ((qty * cents) / 100.0).astype(np.float32)
    del cents
    pct = np.float32(100.0)
    disc = rng.integers(0, 11, size=n, dtype=np.int32).astype(np.float32) / pct
    tax = rng.integers(0, 9, size=n, dtype=np.int32).astype(np.float32) / pct
    starts = np.concatenate([[0], np.cumsum(lines)[:-1]])
    total = np.add.reduceat(price.astype(np.float64) * (1.0 + tax) * (1.0 - disc), starts).astype(np.float32)
    lineitem = {"l_orderkey": np.repeat(o_orderkey, lines), "l_quantity": qty.astype(np.float32),
                "l_extendedprice": price, "l_discount": disc, "l_tax": tax, "l_quantity_i": qty}
    return lines, lineitem, {"l_orderkey": o_orderkey, "o_totalprice": total}


def tpch_reference(lines, li):
    """numpy float64 per-order statistics of FRAME_VALUES: {column: (sum, min, max, std ddof 1, sum of |x|,
    sum of x^2)} and the line counts."""
    import numpy as np

    starts = np.concatenate([[0], np.cumsum(lines)[:-1]])
    out = {}
    for c in FRAME_VALUES:
        x = li[c].astype(np.float64)
        s = np.add.reduceat(x, starts)
        s2 = np.add.reduceat(x * x, starts)
        mean = s / lines
        with np.errstate(invalid="ignore", divide="ignore"):
            std = np.sqrt(np.maximum((s2 - lines * mean * mean) / (lines - 1), 0.0))
        out[c] = (s, np.minimum.reduceat(li[c], starts), np.maximum.reduceat(li[c], starts), std,
                  np.add.reduceat(np.abs(x), starts), s2)
    return out


def frame_checks(tag, g, lines, keys, ref, name=lambda c, a: f"{c}_{a}"):
    """A groupby's global numpy columns ``g`` (the keys under "key", the counts under "count", column c's
    aggregation a under ``name(c, a)``) against the float64 reference: keys, counts, min and max exact; sums, means
    and stds within their float32 bounds. Returns each column's worst shares of the sum and std bounds."""
    import numpy as np

    u = F32_UNIT_ROUNDOFF
    check(np.array_equal(g["key"], keys), f"{tag} keys")
    check(np.array_equal(g["count"], lines), f"{tag} counts")
    worst = {}
    for c, (s, mn, mx, std, sabs, s2) in ref.items():
        check(np.array_equal(g[name(c, "min")], mn) and np.array_equal(g[name(c, "max")], mx), f"{tag} {c} min/max")
        b_sum = TPCH_MAX_LINES * u * sabs
        e_sum = np.abs(g[name(c, "sum")] - s)
        check(bool((e_sum <= b_sum).all()), f"{tag} {c} sums: worst {np.max(e_sum / np.maximum(b_sum, 1e-30))} of "
              f"the bound")
        mean = s / lines
        check(bool((np.abs(g[name(c, "mean")] - mean) <= b_sum / lines + u * np.abs(mean)).all()), f"{tag} {c} means")
        one = lines == 1
        with np.errstate(invalid="ignore", divide="ignore"):
            b_std = np.sqrt(STD_ROUNDINGS * u * (s2 / lines + mean * mean) * lines / (lines - 1)) + u * std
        got_std = g[name(c, "std")]
        e_std = np.abs(got_std - std)
        check(bool(np.isnan(got_std[one]).all() and (e_std[~one] <= b_std[~one]).all()), f"{tag} {c} stds")
        worst[c] = (round(float(np.max(e_sum / np.maximum(b_sum, 1e-30))), 4),
                    round(float(np.max(e_std[~one] / np.maximum(b_std[~one], 1e-30), initial=0.0)), 4))
    return worst


def _timed_step(ht, name, fn, steps, rows):
    """``fn()`` with its host s and CUDA-event ms (synchronized), rows/s, and the SHUFFLE_STATS/MOVE_STATS deltas,
    recorded in ``steps[name]``."""
    import torch

    torch.cuda.synchronize()
    s0, m0 = dict(ht.SHUFFLE_STATS), dict(ht.MOVE_STATS)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    steps[name] = {"host_s": host, "event_ms": a.elapsed_time(b), "rows_per_s": rows / host,
                   "shuffle": {k: ht.SHUFFLE_STATS[k] - s0[k] for k in s0 if ht.SHUFFLE_STATS[k] != s0[k]},
                   "moves": {k: ht.MOVE_STATS[k] - m0[k] for k in m0 if ht.MOVE_STATS[k] != m0[k]}}
    return out


def _frame_steps_line(steps):
    return "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, {v['rows_per_s']:.4e} rows/s, "
                     f"SHUFFLE_STATS {v['shuffle']}, MOVE_STATS {v['moves']}" for k, v in steps.items())


def _host_cols(frame):
    return {name: frame[name].numpy() for name in frame.columns}


# The frame steps [frame] and [dist] share. ``step(name, fn)`` runs and times ``fn`` in the phase's own way and
# ``moves(name)`` is that step's MOVE_STATS delta; every gather is collective, and the comparisons with numpy are
# made where ``here`` (rank 0).
def frame_q6(ht, L):
    """The Q6-shaped filter of lineitem (discount in [0.05, 0.07], quantity < 24) and its revenue, the sum of
    price x discount: (the filtered frame, the revenue)."""
    mask = (L["l_discount"] >= 0.05) & (L["l_discount"] <= 0.07) & (L["l_quantity"] < 24)
    sub = L.filter(mask)
    return sub, ht.sum(sub["l_extendedprice"] * sub["l_discount"]).item()


def frame_q6_checks(tag, sub, revenue, moved, li, here):
    """Q6 moved nothing, its rows are numpy's exactly, and its revenue is within float32's accumulation bound of
    numpy's float64 sum. Returns (the rows kept, the float64 revenue, the bound); the last two None elsewhere."""
    import numpy as np

    u = F32_UNIT_ROUNDOFF
    keep = (li["l_discount"] >= np.float32(0.05)) & (li["l_discount"] <= np.float32(0.07)) & (
        li["l_quantity"] < np.float32(24))
    m = int(keep.sum())
    check(not any(moved.values()) and sub.n_rows == m, f"{tag} Q6 filter: {sub.n_rows} rows (numpy {m}), moves {moved}")
    keys, prices = sub["l_orderkey"].numpy(), sub["l_extendedprice"].numpy()
    if not here:
        return m, None, None
    prod = li["l_extendedprice"][keep].astype(np.float64) * li["l_discount"][keep].astype(np.float64)
    rev64 = float(prod.sum())
    bound = (u + SUM_LAMBDA * math.sqrt(m) * u) * float(np.abs(prod).sum())
    check(np.array_equal(keys, li["l_orderkey"][keep]) and np.array_equal(prices, li["l_extendedprice"][keep]),
          f"{tag} Q6 filter rows")
    check(abs(revenue - rev64) <= bound, f"{tag} Q6 revenue {revenue} vs float64 {rev64} (bound {bound})")
    return m, rev64, bound


def frame_groupbys(ht, G, step, moves, world, lines, od, ref, tag, here):
    """groupby("l_orderkey").agg(FRAME_SPEC) of FRAME_VALUES in range and in hash mode: one bucket move per operand
    (the keys and 13 raw statistics), range-mode groups per rank <= 2 G / P + 32 (C6), and each mode's gathered
    groups (hash mode's put in key order) against numpy's float64 reference. Returns (the range mode's gathered
    columns, its groups per rank, each mode's worst shares of the sum and std bounds where ``here``)."""
    import numpy as np

    n_stats = 4 * len(FRAME_VALUES) + 1  # per column sum (= the float sum), min, max, sum of squares; one count
    shares = {}
    for mode in ("range", "hash"):
        g = step(f"groupby {mode}", lambda: G.groupby("l_orderkey", mode=mode).agg(FRAME_SPEC))
        check(moves(f"groupby {mode}").get("bucket_moves") == n_stats + 1,
              f"{tag} groupby {mode}: one bucket move per operand ({n_stats + 1}): {moves(f'groupby {mode}')}")
        lc = g["l_orderkey"].lcounts or tuple(g["l_orderkey"].lshape_map[:, 0].tolist())
        h = _host_cols(g)
        h["key"] = h.pop("l_orderkey")
        if mode == "range":
            range_cols, range_lc = h, lc
            check(max(lc) <= 2 * TPCH_ORDERS // world + 32, f"{tag} range-mode groups per rank {lc} (C6)")
        else:  # each rank's groups in key order
            order = np.argsort(h["key"], kind="stable")
            h = {k: v[order] for k, v in h.items()}
        if here:
            shares[mode] = frame_checks(f"{tag} groupby {mode}", h, lines, od["l_orderkey"], ref)
        del g, h
    return range_cols, range_lc, shares


def frame_joins(ht, L, step, moves, lines, li, od, tag, here):
    """lineitem's keys and prices joined with orders in range mode, inner, and left against orders without every
    100th order: 4 bucket moves each, every lineitem row kept in key order (each order's lines in theirs), its
    o_totalprice the order's, NaN exactly where the order was dropped."""
    import numpy as np
    import torch

    keep_o = np.arange(TPCH_ORDERS) % TPCH_DROP != 0
    J = ht.Frame({"l_orderkey": L["l_orderkey"], "l_extendedprice": L["l_extendedprice"]})
    want = np.repeat(od["o_totalprice"], lines) if here else None
    for how, right in (("inner", od), ("left", {k: v[keep_o] for k, v in od.items()})):
        O = ht.Frame({k: ht.array(v, split=0) for k, v in right.items()})
        j = step(f"join {how}", lambda: J.join(O, on="l_orderkey", how=how))
        check(moves(f"join {how}").get("bucket_moves") == 4 and j.n_rows == li["l_orderkey"].size,
              f"{tag} join {how}: {j.n_rows} rows, moves {moves(f'join {how}')}")
        keys, price, total = (j[c].numpy() for c in ("l_orderkey", "l_extendedprice", "o_totalprice"))
        if here:
            if how == "left":
                want = np.where(np.repeat(keep_o, lines), want, np.float32(np.nan))
            check(np.array_equal(keys, li["l_orderkey"]) and np.array_equal(price, li["l_extendedprice"])
                  and np.array_equal(total, want, equal_nan=True), f"{tag} {how} join's rows and o_totalprice")
        del j, O, keys, price, total
    del J, want
    torch.cuda.empty_cache()


def frame_streamed(ht, L):
    """StreamingGroupBy(FRAME_SPEC) of l_extendedprice by l_orderkey over lineitem in STREAM_GB_CHUNKS chunks."""
    n = L.n_rows
    sg = ht.stream.StreamingGroupBy(tuple(FRAME_SPEC), capacity=STREAM_GB_CAPACITY)
    step_ = -(-n // STREAM_GB_CHUNKS)
    for lo in range(0, n, step_):
        sg.update(L["l_orderkey"][lo : lo + step_], L["l_extendedprice"][lo : lo + step_])
    return sg.result()


def frame_streamed_checks(tag, res, lines, od, ref, range_cols):
    """StreamingGroupBy's (replicated) result against numpy's float64 reference and the range-mode groupby."""
    import numpy as np

    h = {k: v.numpy() for k, v in res.items()}
    frame_checks(tag, h, lines, od["l_orderkey"], {"l_extendedprice": ref["l_extendedprice"]}, name=lambda c, a: a)
    check(np.array_equal(h["min"], range_cols["l_extendedprice_min"])
          and np.array_equal(h["count"], range_cols["count"]), f"{tag} against the groupby")


def frame_phase(dev, seed, smi):
    """[frame] on one card: TPC-H's lineitem (6.0e7 rows) and orders (1.5e7 rows) at SF 10 made with numpy from the
    seed (:func:`tpch_sf10`), no cut: the Q6-shaped filter and its revenue, groupby("l_orderkey") with sum, mean,
    min, max, std and count of three columns over 1.5e7 groups in range and in hash mode, value_counts of the
    quantity (50 groups, the combiner path), lineitem joined with orders (inner, and left against orders without
    every 100th order), the cluster profile ([main]'s 2^24 x 32 blobs standardized (moments_onepass) and fitted by
    KMeans(8) (lloyd_fused), then a Frame of the labels and two features: groupby("label").agg(mean, std, count)
    and quantile(0.5)), and StreamingGroupBy over lineitem in 8 chunks against the groupby. Every result against
    numpy in float64; each step's host s, CUDA-event ms, rows/s and SHUFFLE_STATS/MOVE_STATS deltas. Returns the
    phase's kernel launches (the cluster profile's)."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht

    ht.use_device("gpu")
    seed = seed + FRAME_SEED_OFFSET
    t_phase = time.perf_counter()
    u = F32_UNIT_ROUNDOFF
    t0 = time.perf_counter()
    lines, li, od = tpch_sf10(seed)
    n = li["l_orderkey"].size
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    L = ht.Frame({k: ht.array(v, split=0) for k, v in li.items()})
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    print(f"[frame] TPC-H SF 10 from seed {seed}: lineitem {n} rows x {len(li)} columns "
          f"({sum(v.nbytes for v in li.values()) / 2**30:.3f} GiB on the card), orders {TPCH_ORDERS} rows; numpy "
          f"{t_gen:.2f} s, to the card {t_up:.2f} s", flush=True)
    steps = {}

    def step(name, fn):
        return _timed_step(ht, name, fn, steps, n)

    def moves(name):
        return steps[name]["moves"]

    # ---- 1. the Q6-shaped filter and its revenue
    sub, revenue = step("Q6 filter + revenue", lambda: frame_q6(ht, L))
    m, rev64, b_rev = frame_q6_checks("[frame]", sub, revenue, moves("Q6 filter + revenue"), li, True)
    print(f"[frame] Q6 filter: {m} rows kept ({sub['l_orderkey'].lcounts or 'balanced'}), revenue {revenue:.6e} vs "
          f"float64 {rev64:.6e} (|err| {abs(revenue - rev64):.3e} <= {b_rev:.3e})", flush=True)
    del sub

    # ---- 2. groupby(l_orderkey) in range and hash mode
    ref = tpch_reference(lines, li)
    G = ht.Frame({"l_orderkey": L["l_orderkey"], **{c: L[c] for c in FRAME_VALUES}})
    range_cols, _, results = frame_groupbys(ht, G, step, moves, 1, lines, od, ref, "[frame]", True)
    print(f"[frame] groupby(l_orderkey).agg({FRAME_SPEC}) of {list(FRAME_VALUES)}: {TPCH_ORDERS} groups; keys, "
          f"counts, min and max exact in both modes; worst share of the bound (sum, std) per column {results}",
          flush=True)

    # ---- 3. value_counts of the int32 quantity: 50 groups
    vc = step("value_counts", lambda: L.value_counts("l_quantity_i"))
    check(np.array_equal(vc["l_quantity_i"].numpy(), np.arange(1, 51)) and np.array_equal(
        vc["count"].numpy(), np.bincount(li["l_quantity_i"], minlength=51)[1:]), "[frame] value_counts")

    # ---- 4. lineitem joined with orders: inner, and left without every 100th order
    frame_joins(ht, L, step, moves, lines, li, od, "[frame]", True)

    # ---- 5. the cluster profile: standardize, KMeans(8), then a frame of the labels and two features
    before = dict(ht.LAUNCHES)
    ht.random.seed(seed)
    x, member = gnb_blobs(ht, N_MAIN, gnb_centres(ht))

    def profile():
        mu, sd = ht.mean(x, axis=0), ht.std(x, axis=0)
        z = (x - mu) / sd
        km = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
        P = ht.Frame({"label": km.labels_, "f0": z[:, 0], "f1": z[:, 1]})
        return z, km, P, P.groupby("label").agg(["mean", "std", "count"]), P.groupby("label").quantile(0.5)

    z, km, P, st, qt = _timed_step(ht, "cluster profile", profile, steps, N_MAIN)
    launches = {k: v - before.get(k, 0) for k, v in ht.LAUNCHES.items() if v != before.get(k, 0)}
    check(launches.get("moments_onepass", 0) >= 1 and launches.get("lloyd_fused", 0) == ITERS + 1,
          f"[frame] cluster profile launches {launches}")
    lab = km.labels_.larray
    counts = torch.bincount(lab, minlength=K_MAIN)
    check(np.array_equal(st["count"].numpy(), counts.cpu().numpy()) and np.array_equal(st["label"].numpy(),
                                                                                       np.arange(K_MAIN)),
          "[frame] cluster profile counts")
    order = torch.sort(lab, stable=True).indices
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)]).tolist()
    q_worst, eps = 0.0, 3 / (2 * QUANTILE_K)  # one fold and no merge: (3 + ceil(log2 1)) / (2k)
    for j_, col in enumerate(("f0", "f1")):
        v = z.larray[:, j_][order].double()
        got_mean, got_std, got_q = st[f"{col}_mean"].numpy(), st[f"{col}_std"].numpy(), qt[col].numpy()
        for c in range(K_MAIN):
            seg = v[bounds[c] : bounds[c + 1]]
            mc, sc = seg.mean().item(), seg.std().item()
            s2 = (seg * seg).mean().item()
            m_ = seg.numel()
            b_m = SUM_LAMBDA * math.sqrt(m_) * u * seg.abs().mean().item() + u * abs(mc)
            b_s = math.sqrt(2 * SUM_LAMBDA * math.sqrt(m_) * u * (s2 + mc * mc) * m_ / (m_ - 1)) + u * sc
            check(abs(got_mean[c] - mc) <= b_m and abs(got_std[c] - sc) <= b_s,
                  f"[frame] profile {col} group {c}: mean {got_mean[c]} vs {mc}, std {got_std[c]} vs {sc}")
            srt = torch.sort(seg.float()).values
            lo = int(torch.searchsorted(srt, torch.tensor([got_q[c]], device=dev), right=False))
            hi = int(torch.searchsorted(srt, torch.tensor([got_q[c]], device=dev), right=True))
            t_ = 0.5 * (m_ - 1)
            q_worst = max(q_worst, max(0.0, lo - t_, t_ - hi) / m_)
    check(q_worst <= eps, f"[frame] quantile rank error {q_worst} > {eps}")
    print(f"[frame] cluster profile on {N_MAIN} x {F_MAIN} blobs: launches {launches}; groupby(label) counts exact, "
          f"mean/std within the accumulation bounds; quantile(0.5) rank error {q_worst:.3e} (<= {eps:.3e})",
          flush=True)
    del x, member, z, km, P, st, qt, lab, order
    torch.cuda.empty_cache()

    # ---- 6. StreamingGroupBy over lineitem in 8 chunks, against the groupby
    res = step("StreamingGroupBy", lambda: frame_streamed(ht, L))
    frame_streamed_checks("[frame] StreamingGroupBy", res, lines, od, ref, range_cols)
    del res, range_cols, L, G
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[frame] steps: {_frame_steps_line(steps)}", flush=True)
    print(f"[frame] phase {wall:.1f} s host ({smi}); launches {launches}", flush=True)
    return launches


def resilience_phase(dev, seed, smi):
    """[resilience] on one card: save_checkpoint/load_checkpoint of the 2^24 x 32 float32 blobs (2 GiB) with crc32
    and with sha256 and of lineitem's six columns, bit for bit, in GB/s; a torn write under chaos(torn_write=1.0,
    max_faults=2) recovered by DEFAULT_CHECKPOINT_POLICY; a corrupted shard raising CheckpointCorruptionError
    naming the file; fingerprint of the blobs (host copy + crc32) and health_check(check_values=True), in ms; a
    straggler under deadlines(...) raising CollectiveTimeout."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht

    ht.use_device("gpu")
    rz = ht.resilience
    seed = seed + FRAME_SEED_OFFSET
    t_phase = time.perf_counter()
    ht.random.seed(seed)
    x, _ = gnb_blobs(ht, N_MAIN, gnb_centres(ht))
    nbytes = x.larray.numel() * 4
    tmp = stream_space("[resilience]", "chip_smoke_resilience_")
    lines_out = []
    try:
        d = os.path.join(tmp, "blobs")
        for algo in ("crc32", "sha256"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rz.save_checkpoint(x, d, checksum=algo)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            y = rz.load_checkpoint(d)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            check(y.split == 0 and torch.equal(y.larray, x.larray), f"[resilience] {algo} checkpoint round trip")
            lines_out.append(f"{algo}: save {t_save:.3f} s ({nbytes / t_save / 1e9:.3f} GB/s), load {t_load:.3f} s "
                             f"({nbytes / t_load / 1e9:.3f} GB/s)")
            del y
            shutil.rmtree(d)
        print(f"[resilience] checkpoint of {tuple(x.gshape)} float32 ({nbytes / 2**30:.2f} GiB), bit for bit: "
              + "; ".join(lines_out), flush=True)
        _, li, _ = tpch_sf10(seed)
        cols = {k: ht.array(v, split=0) for k, v in li.items()}
        del li
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, c in cols.items():
            rz.save_checkpoint(c, os.path.join(tmp, k))
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        for k, c in cols.items():
            check(torch.equal(rz.load_checkpoint(os.path.join(tmp, k)).larray, c.larray), f"[resilience] {k}")
        t_load = time.perf_counter() - t0
        lb = sum(c.larray.numel() * c.larray.element_size() for c in cols.values())
        print(f"[resilience] lineitem's {len(cols)} columns ({lb / 2**30:.3f} GiB, crc32), bit for bit: save "
              f"{t_save:.3f} s ({lb / t_save / 1e9:.3f} GB/s), load {t_load:.3f} s ({lb / t_load / 1e9:.3f} GB/s)",
              flush=True)
        for k in cols:
            shutil.rmtree(os.path.join(tmp, k))
        del cols
        small = x[:CKPT_SMALL]
        ds = os.path.join(tmp, "torn")
        with rz.chaos(seed=seed, torn_write=1.0, max_faults=2) as c:
            rz.save_checkpoint(small, ds)
        check([i.kind for i in c.injected] == ["torn_write", "torn_write"]
              and torch.equal(rz.load_checkpoint(ds).larray, small.larray)
              and not [f for f in os.listdir(ds) if ".tmp-" in f], f"[resilience] torn writes: {c.report()}")
        shard = os.path.join(ds, "shard_000000000000.npy")
        with open(shard, "r+b") as f:
            f.seek(4096)
            b = f.read(1)
            f.seek(4096)
            f.write(bytes([b[0] ^ 0xFF]))
        try:
            rz.load_checkpoint(ds)
            check(False, "[resilience] a corrupted shard loaded")
        except rz.CheckpointCorruptionError as e:
            check("shard_000000000000.npy" in str(e), f"[resilience] the corruption error names the file: {e}")
        print(f"[resilience] {c.report()!r}: recovered by DEFAULT_CHECKPOINT_POLICY, loaded bit for bit; a flipped "
              f"byte raised CheckpointCorruptionError naming the shard", flush=True)
        shutil.rmtree(ds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    def host_ms(fn):  # a warm call, then one timed (both end on the host)
        fn()
        t_ = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t_) * 1e3, out_

    ms_fp, fp = host_ms(lambda: rz.fingerprint(x))
    check(len(fp.groups) == 1 and fp.groups[0][1][0][0] == 0, f"[resilience] fingerprint {fp}")
    ms_hc, _ = host_ms(lambda: x.health_check(check_values=True))
    f = ht.Frame({"k": ht.array(np.arange(1 << 16, dtype=np.int32) % 97, split=0),
                  "v": ht.array(np.ones(1 << 16, np.float32), split=0)})
    t0 = time.perf_counter()
    try:
        with rz.deadlines(STRAGGLER_DEADLINE):
            with rz.chaos(seed=seed, straggler=1.0, straggler_delay=STRAGGLER_DELAY, targets=("collective",),
                          max_faults=1):
                f.groupby("k").sum()
        check(False, "[resilience] the straggler was not caught")
    except rz.CollectiveTimeout as e:
        waited = time.perf_counter() - t0
        check(e.label == "flatmove.bucket" and waited < STRAGGLER_DELAY, f"[resilience] {e} after {waited} s")
    time.sleep(STRAGGLER_DELAY)  # the abandoned worker finishes its move before the card is used again
    print(f"[resilience] fingerprint of {nbytes / 2**30:.2f} GiB (host copy + crc32) {ms_fp:.4f} ms "
          f"({nbytes / ms_fp / 1e6:.3f} GB/s); health_check(check_values=True) {ms_hc:.4f} ms; a {STRAGGLER_DELAY} s "
          f"straggler under deadlines({STRAGGLER_DEADLINE}) raised CollectiveTimeout('flatmove.bucket') after "
          f"{waited:.3f} s", flush=True)
    del x
    torch.cuda.empty_cache()
    print(f"[resilience] phase {time.perf_counter() - t_phase:.1f} s host ({smi})", flush=True)


def _dist_frame(ht, world, rank, timed, same_everywhere, say, seed):
    """[dist]'s frame steps: every rank makes the SF-10 data from the seed and keeps its rows (split 0); [frame]'s
    Q6 filter, groupby in both modes, joins and StreamingGroupBy (log2 P tree_merge rounds, bit-identical on every
    rank) and value_counts; rank 0 holds the gathered results against numpy as [frame] does. Returns the steps'
    times."""
    import numpy as np
    import torch

    seed = seed + FRAME_SEED_OFFSET
    lines, li, od = tpch_sf10(seed)
    L = ht.Frame({k: ht.array(v, split=0) for k, v in li.items()})
    out = {"steps": {}}
    here = rank == 0

    def step(name, fn):
        s0, m0 = dict(ht.SHUFFLE_STATS), dict(ht.MOVE_STATS)
        res, host, ev = timed(fn)
        out["steps"][name] = {"host_s": host, "event_ms": ev, "collectives": timed.collectives,
                              "shuffle": {k: ht.SHUFFLE_STATS[k] - s0[k] for k in s0},
                              "moves": {k: ht.MOVE_STATS[k] - m0[k] for k in m0}}
        return res

    def moves(name):
        return out["steps"][name]["moves"]

    sub, revenue = step("Q6 filter + revenue", lambda: frame_q6(ht, L))
    frame_q6_checks("[dist]", sub, revenue, moves("Q6 filter + revenue"), li, here)
    del sub
    ref = tpch_reference(lines, li) if here else None
    G = ht.Frame({"l_orderkey": L["l_orderkey"], **{c: L[c] for c in FRAME_VALUES}})
    range_cols, out["range_lcounts"], _ = frame_groupbys(ht, G, step, moves, world, lines, od, ref, "[dist]", here)
    vc = step("value_counts", lambda: L.value_counts("l_quantity_i"))
    check(np.array_equal(vc["count"].numpy(), np.bincount(li["l_quantity_i"], minlength=51)[1:]),
          "[dist] value_counts")
    frame_joins(ht, L, step, moves, lines, li, od, "[dist]", here)
    res = step("StreamingGroupBy", lambda: frame_streamed(ht, L))
    mv = moves("StreamingGroupBy")
    check(mv["tree_merges"] == (1 if world > 1 else 0) and mv["tree_merge_rounds"] == ht.tree_merge_rounds(world),
          f"[dist] StreamingGroupBy merge: {mv}")
    for k, v in res.items():  # bit for bit: float32 as its bit patterns, so that the NaN stds compare equal
        t = v.larray
        same_everywhere(t.view(torch.int32) if t.dtype == torch.float32 else t, f"StreamingGroupBy {k}")
    if here:
        frame_streamed_checks("[dist] StreamingGroupBy", res, lines, od, ref, range_cols)
    say("frame: " + "; ".join(f"{k} {v['host_s']:.4f} s host, {v['event_ms']:.4f} ms events, moves "
                              f"{ {m: c for m, c in v['moves'].items() if c} }" for k, v in out["steps"].items())
        + f"; range-mode groups per rank {out['range_lcounts']}")
    del res, L, G, range_cols
    torch.cuda.empty_cache()
    return out


def _dist_resilience(ht, world, rank, say, out_dir, seed):
    """[dist]'s resilience steps: a checkpoint saved by every rank loads in one process bit for bit and a
    one-process checkpoint loads split over the ranks; a divergence fault entered on the last rank alone raises
    the same DivergenceError naming it on every rank."""
    import torch

    rz = ht.resilience
    comm = ht.get_comm()
    gen = torch.Generator(device=ht.get_device().torch_device)
    gen.manual_seed(seed + FRAME_SEED_OFFSET)
    full = torch.randn(N_DIST_CKPT * world, F_MAIN, device=ht.get_device().torch_device, generator=gen)
    x = ht.array(full, split=0)
    d_all, d_one = os.path.join(out_dir, "ckpt_all"), os.path.join(out_dir, "ckpt_one")
    t0 = time.perf_counter()
    rz.save_checkpoint(x, d_all)
    t_save = time.perf_counter() - t0
    if rank == 0:
        one = rz.load_checkpoint(d_all, comm=ht.SELF)
        check(torch.equal(one.larray, full), "[dist] the ranks' checkpoint loaded by one process")
        rz.save_checkpoint(ht.array(full, split=0, comm=ht.SELF), d_one)
        del one
    comm.barrier()
    y = rz.load_checkpoint(d_one)
    check(torch.equal(y.larray, x.larray) and y.split == 0, "[dist] a one-process checkpoint loaded split")
    rep = ht.array(full[:4096])
    culprit = min(2, world - 1)
    # at one rank the culprit is the primary replica, where a divergence stays pending
    with rz.FaultSchedule([("guard.shard", 1, "divergence")] if rank == culprit else []) as fs:
        try:
            rz.check_divergence(rep)
            raised = None
        except rz.DivergenceError as e:
            raised = e
    if culprit > 0:
        check(raised is not None and list(raised.devices) == [culprit], f"[dist] divergence on rank {culprit}: {raised}")
    else:
        check(raised is None and fs.pending(), "[dist] one rank holds no second replica to diverge")
    comm.barrier()
    if rank == 0:
        shutil.rmtree(d_all, ignore_errors=True)
        shutil.rmtree(d_one, ignore_errors=True)
    say(f"resilience: checkpoint of {tuple(x.gshape)} saved by {world} rank(s) in {t_save:.3f} s loads in one "
        f"process bit for bit, a one-process checkpoint loads split; divergence on rank {culprit}: "
        f"{'DivergenceError naming it on every rank' if culprit else 'no replica to diverge at one rank'}")
    del x, y, full
    torch.cuda.empty_cache()


# ---- [serve]: supervised fits and the resident service over the fitted models
SERVE_SEED_OFFSET = 500        # [serve]'s and [dist]'s serve steps draw their numpy streams from --seed + this
N_SERVE_REQ, SERVE_MAX_ROWS = 4096, 64  # the open-loop trace: requests of 1-64 rows x 32, uniform
N_SERVE_UNBATCHED = 512        # the unbatched leg plays the trace's first requests
SERVE_GAP_S = 0.25e-3          # the trace's fixed gap between submissions
SERVE_MAX_BATCH, SERVE_LATENCY_MS = 256, 2.0
SERVE_TIMEOUT = 300.0          # seconds any one result() may wait
SUP_BLOCK, SUP_EVERY = 4, 2    # the supervised fit: 4 Lloyd iterations a step, a checkpoint every 2 steps
SUP_FAULT_STEP = 3             # the step the scripted faults hit
MON_TICKS = 20                 # [serve]'s clean monitor ticks
SERVE_QUEUE_DEPTH = 8          # the overload drill's high-water mark
N_DIST_SERVE_REQ = 512         # [dist]'s trace
DIST_MON_S, DIST_HEAL_AFTER = 0.02, 3  # [dist]'s health monitor: probe cadence (s) and clean ticks to heal
DIST_SERVE_WAIT = 60.0         # seconds [dist] waits for the flap's shrink and grow


def serve_trace(seed, n):
    """The open-loop trace: n requests of 1..SERVE_MAX_ROWS rows x F_MAIN (uniform), every 4th to km.predict and
    the others to knn.predict."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = rng.integers(1, SERVE_MAX_ROWS + 1, size=n)
    return [("km.predict" if i % 4 == 0 else "knn.predict", rng.normal(size=(int(r), F_MAIN)).astype(np.float32))
            for i, r in enumerate(rows)]


def serve_fits(ht, z, init, directory, faults, say, tag):
    """A supervised KMeans(K_MAIN, init, ITERS, tol=None) fit (SUP_BLOCK iterations a step, a checkpoint every
    SUP_EVERY steps) under the FaultSchedule ``faults``; returns (estimator, lloyd_fused launches, RECOVERY_STATS
    deltas, host s, the schedule's record)."""
    import torch

    rz = ht.resilience
    before = dict(rz.RECOVERY_STATS)
    l0 = ht.LAUNCHES.get("lloyd_fused", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup = rz.Supervisor(directory, rz.CheckpointSchedule(every_steps=SUP_EVERY),
                        retry=rz.RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0, seed=0))
    with rz.FaultSchedule(faults) as fs:
        km = ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(
            z, supervisor=sup, block_iters=SUP_BLOCK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counters = {k: rz.RECOVERY_STATS[k] - before[k] for k in before if k != "recovery_seconds_total"}
    launches = ht.LAUNCHES.get("lloyd_fused", 0) - l0
    say(f"{tag}: {launches} lloyd_fused launches, {secs:.4f} s host, RECOVERY_STATS {counters}; {fs.report()!r}")
    return km, launches, counters, secs, fs


def serve_service(ht, km, clf, max_batch=SERVE_MAX_BATCH, **kw):
    """A ServeService of the two models (endpoints km.predict and knn.predict)."""
    svc = ht.serve.ServeService(ht.serve.BucketPolicy(max_batch=max_batch, max_latency_ms=SERVE_LATENCY_MS), **kw)
    svc.register_model("km", km)
    svc.register_model("knn", clf)
    return svc


def serve_warm(ht, svc, max_rows):
    """Dispatch one request of every bucket up to ``max_rows`` rows to both endpoints, each alone."""
    import numpy as np

    rng = np.random.default_rng(0)
    b = 1
    while b <= max_rows:
        for ep in ("km.predict", "knn.predict"):
            r = svc.submit(ep, rng.normal(size=(b, F_MAIN)).astype(np.float32))
            svc.flush()
            r.result(SERVE_TIMEOUT)
        b *= 2


def serve_play(ht, svc, trace, gap_s=SERVE_GAP_S):
    """Play ``trace`` open-loop (request i submitted at i * gap_s), flush, and wait for every answer; returns
    (answers: rows or the exception, the requests, SERVE_STATS of the leg with ``knn_fused``: the kNN batch
    dispatches of 2 rows or more, which take the fused route, LAUNCHES deltas, seconds)."""
    from heat_tpu_torch.core import _hooks

    ht.serve.reset_serve_stats()
    l0 = dict(ht.LAUNCHES)
    fused = [0]

    def on_dispatch(name, ctx):  # the serve.dispatch fault point: one per batch attempt, with its bucket
        if name == "serve.dispatch" and ctx.get("endpoint") == "knn.predict" and ctx.get("bucket", 0) >= 2:
            fused[0] += 1

    _hooks.add_observer(on_dispatch)
    try:
        out = _serve_play(ht, svc, trace, gap_s, l0)
    finally:
        _hooks.remove_observer(on_dispatch)
    out[2]["knn_fused"] = fused[0]
    return out


def _serve_play(ht, svc, trace, gap_s, l0):
    t0 = time.perf_counter()
    reqs = []
    for i, (ep, p) in enumerate(trace):
        delay = t0 + i * gap_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        reqs.append(svc.submit(ep, p))
    svc.flush()
    answers = []
    for r in reqs:
        try:
            answers.append(r.result(SERVE_TIMEOUT))
        except Exception as e:  # noqa: BLE001 - the caller holds which requests may carry which error
            answers.append(e)
    secs = time.perf_counter() - t0
    stats = svc.stats()
    launches = {k: v - l0.get(k, 0) for k, v in ht.LAUNCHES.items() if v != l0.get(k, 0)}
    return answers, reqs, stats, launches, secs


def serve_leg_line(tag, trace, stats, launches, secs):
    occ = stats["batched_rows"] / max(1, stats["batched_rows"] + stats["padded_rows"])
    return (f"{tag}: {len(trace)} requests in {secs:.4f} s = {len(trace) / secs:.2f} requests/s; p50 "
            f"{stats['p50_latency_ms']:.4f} ms, p99 {stats['p99_latency_ms']:.4f} ms; {stats['batches']} batches, "
            f"{stats['batched_rows'] / max(1, stats['batches']):.2f} rows a batch, bucket occupancy {occ:.4f}; "
            f"SERVE_STATS {dict((k, v) for k, v in stats.items() if v and not k.endswith('_ms'))}; LAUNCHES {launches}")


def serve_references(ht, km, clf, trace):
    """The models' own predict on the trace's rows: (KMeans labels, kNN labels), each over the concatenation of
    its endpoint's requests, as numpy. The kNN labels come from topk_distance's plain version (knn_tiles, under
    forced_mode), so that the served rows, which went through the kernel, are held against it."""
    import numpy as np

    from heat_tpu_torch.core.kernels import TOPK_KERNEL, forced_mode

    out = {}
    for ep, model in (("km.predict", km), ("knn.predict", clf)):
        rows = [p for e, p in trace if e == ep]
        q = ht.array(np.concatenate(rows), split=0)
        with forced_mode(TOPK_KERNEL, "torch"):
            out[ep] = model.predict(q).numpy()
    return out


def serve_verify(ht, tag, km, clf, train, trace, answers, refs, allow=()):
    """Every answer of ``trace`` against the models' own predict of the same rows: KMeans labels equal but where
    the two smallest d2 are within TIE_RTOL; kNN labels equal but where the k-th and (k + 1)-th nearest training
    rows (found by topk_distance's plain version) lie within the float32 rounding bound of the distances
    (knn_check's). An exception is allowed only of a type in ``allow``. Returns (rows answered, errors, KMeans tie
    rows, kNN tie rows)."""
    import numpy as np
    import torch

    from heat_tpu_torch.core.kernels import knn_tiles
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    dev = ht.get_device().torch_device
    at = {"km.predict": 0, "knn.predict": 0}
    bad = {"km.predict": [], "knn.predict": []}
    answered = errors = 0
    for (ep, p), a in zip(trace, answers):
        n = p.shape[0]
        want = refs[ep][at[ep]:at[ep] + n]
        at[ep] += n
        if isinstance(a, BaseException):
            check(isinstance(a, allow), f"{tag}: a request to {ep} answered {type(a).__name__}: {a}")
            errors += 1
            continue
        answered += 1
        got = np.asarray(a)
        check(got.shape == want.shape, f"{tag}: {ep} answered {got.shape} rows for {want.shape}")
        for i in np.nonzero(got != want)[0]:
            bad[ep].append(p[i])
    ties = {}
    for ep, rows in bad.items():
        if not rows:
            ties[ep] = 0
            continue
        q = torch.from_numpy(np.stack(rows)).to(dev)
        if ep == "km.predict":
            d2 = _quadratic_expand(q.double(), km.cluster_centers_.larray.double())
            two = torch.topk(d2, 2, dim=1, largest=False).values
            check(bool(((two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]).all()),
                  f"{tag}: KMeans labels differ from predict outside near-ties")
        else:
            y = train.larray if train.split is None or not train.comm.is_distributed() else train._logical()
            _, idx = knn_tiles(q, y, KNN_K + 1)
            nb = y[idx.long()].double()  # (R, k + 1, f)
            xr = q.double().unsqueeze(1)
            dist = ((xr - nb) ** 2).sum(-1)
            nr = (F_MAIN + 2) * F32_UNIT_ROUNDOFF
            e = nr / (1 - nr) * (xr.norm(dim=2) + nb.norm(dim=2)) ** 2
            gap = (dist[:, KNN_K] - dist[:, KNN_K - 1]).abs()
            check(bool((gap <= 4 * e.amax(1)).all()), f"{tag}: kNN labels differ from predict outside near-ties")
        ties[ep] = len(rows)
    return answered, errors, ties["km.predict"], ties["knn.predict"]


def serve_phase(dev, seed, smi):
    """[serve] on one card: 8 blobs of 2^24 x 32 (``ht.random``), standardized; the KMeans fit plain and
    supervised (clean, and with three transient faults at step 3 that exhaust the step's retries and end in a
    checkpoint restore); a kNN classifier on the first 2^22 standardized rows and the KMeans in one
    ``ServeService`` (BucketPolicy(max_batch=256, max_latency_ms=2), a snapshot directory, an Autoscaler over a
    HealthMonitor(interval_s=3600)); the open-loop trace batched and unbatched, every served row against the
    models' own predict; the fault drills; clean monitor ticks. Returns the path's kernel launches."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import _build

    ht.use_device("gpu")
    rz = ht.resilience
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")

    def say(msg):
        print(f"[serve] {msg}", flush=True)

    try:
        ht.kernels.reset_kernel_stats()
        # ---- the path, counts zeroed just before: data, standardize, the fits, the service's legs
        _, member, x, _, _ = _dist_data(ht, 1)
        z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
        del x
        init = z[:K_MAIN]
        l0 = ht.LAUNCHES.get("lloyd_fused", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean = ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(z)
        torch.cuda.synchronize()
        t_clean, n_clean = time.perf_counter() - t0, ht.LAUNCHES.get("lloyd_fused", 0) - l0
        c0 = clean.cluster_centers_.larray
        km, n_sup, rc, t_sup, _ = serve_fits(ht, z, init, os.path.join(tmp, "fit"), [], say,
                                             "supervised fit (clean)")
        check(rc["checkpoints"] >= 2 and rc["detections"] == 0, f"[serve] clean supervised fit: {rc}")
        restore = [("supervisor.step", SUP_FAULT_STEP + 1 + i, "io_error") for i in range(3)]
        km_r, n_rest, rr, t_rest, fs = serve_fits(ht, z, init, os.path.join(tmp, "fit_restore"), restore, say,
                                                  "supervised fit, 3 I/O errors at step 3")
        check(not fs.pending() and rr["retries"] == 2 and rr["restores"] == 1 and km_r.n_iter_ == ITERS,
              f"[serve] restore fit: {rr}, pending {fs.pending()}")
        for name, k in (("clean supervised", km), ("restored supervised", km_r)):
            cd = (k.cluster_centers_.larray - c0).abs().max().item()
            check(cd <= CENTERS_RTOL * c0.abs().max().item(), f"[serve] {name} centres vs the plain fit: {cd}")
        say(f"lloyd_fused launches: plain fit {n_clean} ({t_clean:.4f} s host), supervised {n_sup} ({t_sup:.4f} s), "
            f"supervised with the restore {n_rest} ({t_rest:.4f} s); centres of both within {CENTERS_RTOL} of the "
            f"plain fit's max |c|")
        served = ht.cluster.KMeans(n_clusters=K_MAIN).load_state_dict(
            {k: v for k, v in km.state_dict().items() if k not in ("labels", "labels_split")})
        train, train_labels = z[:N_TRAIN], km.labels_[:N_TRAIN]
        clf = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, train_labels)
        snap = os.path.join(tmp, "snapshot")
        svc = serve_service(ht, served, clf, snapshot_dir=snap,
                            autoscaler=ht.serve.Autoscaler(ht.resilience.HealthMonitor(interval_s=3600.0)))
        unb = serve_service(ht, served, clf, max_batch=1)
        trace = serve_trace(seed + SERVE_SEED_OFFSET, N_SERVE_REQ)
        try:
            serve_warm(ht, svc, SERVE_MAX_BATCH)
            serve_warm(ht, unb, SERVE_MAX_ROWS)
            libs = dict(_build._libs)
            leg_b = serve_play(ht, svc, trace)
            leg_u = serve_play(ht, unb, trace[:N_SERVE_UNBATCHED])
            check(_build._libs == libs, "[serve] a warm leg loaded or built a kernel library")
        finally:
            unb.close(SERVE_TIMEOUT)
        path_launches = dict(ht.LAUNCHES)
        for tag, leg, tr in (("batched", leg_b, trace), ("unbatched (max_batch=1)", leg_u, trace[:N_SERVE_UNBATCHED])):
            answers, reqs, stats, launches, secs = leg
            say(serve_leg_line(tag, tr, stats, launches, secs))
            check(all(r.answers == 1 for r in reqs), f"[serve] {tag}: a request answered more than once")
            check(stats["bucket_misses"] == 0 and stats["errors"] == 0 and stats["scale_events"] == 0,
                  f"[serve] {tag}: a cold bucket, an error or a scale event on the warm leg: {stats}")
            # a kNN batch of one row (n * m = 2^22 pairs) takes heat_tpu's materializing route, as predict does
            check(launches.get("topk_distance", 0) == stats["knn_fused"],
                  f"[serve] {tag}: topk_distance launches {launches.get('topk_distance', 0)} != the kNN batches of 2 "
                  f"rows or more ({stats['knn_fused']})")
        refs = serve_references(ht, served, clf, trace)
        for tag, leg, tr in (("batched", leg_b, trace), ("unbatched", leg_u, trace[:N_SERVE_UNBATCHED])):
            n_ok, _, km_ties, knn_ties = serve_verify(ht, f"[serve] {tag}", served, clf, train, tr, leg[0], refs)
            say(f"{tag}: all {n_ok} requests' rows equal the models' own predict (KMeans near-tie rows {km_ties}, "
                f"kNN near-tie rows {knn_ties})")
        say(f"batched / unbatched requests/s: {len(trace) / leg_b[4] / (N_SERVE_UNBATCHED / leg_u[4]):.3f}")

        # ---- topk_distance at the serve buckets (not on the counted path): each bucket's kernel call on the
        # trace's first kNN rows against the plain version, and its time
        tk = ht.core.kernels
        q_all = torch.from_numpy(np.concatenate([p for e, p in trace if e == "knn.predict"])[:SERVE_MAX_BATCH]).to(dev)
        sms, per_sm = tk.topk_distance._occupancy(0, F_MAIN, KNN_K)
        lines = []
        for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            q = q_all[:b]
            d, i = tk.nearest_neighbors_local(q, train.larray, KNN_K)
            d0, i0 = tk.knn_tiles(q, train.larray, KNN_K)
            e_d, ndiff, worst = knn_check(q, train.larray, d, i, d0, i0)
            ms = time_ms(lambda: tk.nearest_neighbors_local(q, train.larray, KNN_K), reps=10)
            nseg, seg_len = tk.topk_distance.knn_plan(b, N_TRAIN, KNN_K, sms, per_sm)
            blocks = -(-b // tk.topk_distance._ROWS) * nseg
            lines.append(f"n={b}: {ms:.4f} ms, {blocks} blocks ({nseg} y-segments of {seg_len} rows), distances max "
                         f"abs {e_d:.3e} vs knn_tiles, indices differ on {ndiff} entries (largest gap {worst:.3f} "
                         f"of the rounding bound)")
            del d, i, d0, i0
        say(f"topk_distance at the serve buckets against knn_tiles (m={N_TRAIN}, f={F_MAIN}, k={KNN_K}; {per_sm} "
            f"blocks/SM x {sms} SMs; CUDA events, median of 10): " + "; ".join(lines))
        for b in (1, 32, 256):
            nseg, seg_len = ht.core.kernels.topk_distance.knn_plan(b, N_TRAIN, KNN_K, sms, per_sm)
            print(f"[design] topk_distance at a serve batch of n={b}: {-(-b // ht.core.kernels.topk_distance._ROWS)} "
                  f"query block(s) x {nseg} y-segments of {seg_len} rows = "
                  f"{-(-b // ht.core.kernels.topk_distance._ROWS) * nseg} blocks on {sms} SMs", flush=True)

        # ---- drills, on a service sharing the models, snapshotting after every good batch
        drill = serve_service(ht, served, clf, snapshot_dir=snap, snapshot_every=1,
                              retry=rz.RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0, seed=0))
        rng = np.random.default_rng(seed + SERVE_SEED_OFFSET + 1)
        armed = {"timeout": False}

        def guarded(xq):
            if bool(torch.isnan(xq.larray).any()):
                raise ValueError("a NaN row")
            if armed["timeout"]:
                armed["timeout"] = False
                raise rz.CollectiveTimeout("serve.drill", 1.0, 0.5, "resident state suspect")
            return served.predict(xq)

        drill.register_endpoint("km.guarded", guarded)
        try:
            p0 = rng.normal(size=(3, F_MAIN)).astype(np.float32)
            drill.submit("km.predict", p0).result(SERVE_TIMEOUT)  # a good batch: the snapshot exists
            s0 = dict(ht.serve.SERVE_STATS)
            good = [rng.normal(size=(int(r), F_MAIN)).astype(np.float32) for r in rng.integers(1, 9, size=7)]
            poison = np.full((2, F_MAIN), np.nan, np.float32)
            reqs = [drill.submit("km.guarded", p) for p in good[:3] + [poison] + good[3:]]
            drill.flush()
            outs = []
            for r in reqs:
                try:
                    outs.append(r.result(SERVE_TIMEOUT))
                except rz.PoisonRequestError as e:
                    outs.append(e)
            check(isinstance(outs[3], rz.PoisonRequestError)
                  and all(np.array_equal(o, served.predict(ht.array(p)).numpy())
                          for o, p in zip(outs[:3] + outs[4:], good)),
                  "[serve] poison drill: the poison request isolated, its neighbours' rows")
            with rz.chaos(seed=seed, io_error=1.0, max_faults=2, targets=("serve",)) as ch:
                r = drill.submit("knn.predict", good[0])
                drill.flush()
                got = r.result(SERVE_TIMEOUT)
            check(np.array_equal(got, clf.predict(ht.array(good[0])).numpy()) and len(ch.injected) == 2,
                  f"[serve] chaos drill: {ch.report()}")
            armed["timeout"] = True
            r = drill.submit("km.guarded", good[1])
            drill.flush()
            check(np.array_equal(r.result(SERVE_TIMEOUT), served.predict(ht.array(good[1])).numpy()),
                  "[serve] restore drill: the replayed batch's rows")
            d = {k: ht.serve.SERVE_STATS[k] - s0[k] for k in ("bisections", "retries", "restores", "redispatched")}
            # restores: the poison drill rolls the registry back too (a poison payload may have touched it)
            check(d["bisections"] == 1 and d["retries"] == 2 and d["restores"] == 2 and d["redispatched"] >= 1,
                  f"[serve] drills: {d}")
        finally:
            drill.close(SERVE_TIMEOUT)
        gate, running = threading.Event(), threading.Event()

        def block():
            running.set()
            gate.wait(SERVE_TIMEOUT)

        adm = serve_service(ht, served, clf, max_queue_depth=SERVE_QUEUE_DEPTH)
        try:
            blocker = adm.submit_call(block)
            check(running.wait(SERVE_TIMEOUT), "[serve] the admission drill's blocking call never ran")
            try:
                acc = [adm.submit("km.predict", good[i % 7]) for i in range(SERVE_QUEUE_DEPTH - 1)]
                doomed = adm.submit("km.predict", good[0], deadline_ms=0.0)
                try:
                    adm.submit("km.predict", good[0])
                    check(False, "[serve] a submit past max_queue_depth was accepted")
                except rz.ServeOverloadError:
                    pass
            finally:
                gate.set()
            blocker.result(SERVE_TIMEOUT)
            adm.drain(SERVE_TIMEOUT)
            try:
                doomed.result(SERVE_TIMEOUT)
                check(False, "[serve] an expired deadline was served")
            except rz.ServeDeadlineError:
                pass
            check(all(r.answers == 1 for r in acc + [doomed]), "[serve] admission drill answers")
        finally:
            adm.close(SERVE_TIMEOUT)
        say(f"drills: a NaN request isolated by bisection (PoisonRequestError) while its 7 neighbours got their rows; "
            f"{ch.report()!r} absorbed by 2 retries; a CollectiveTimeout restored the registry from its snapshot and "
            f"replayed the batch; past max_queue_depth={SERVE_QUEUE_DEPTH} ServeOverloadError; an expired deadline "
            f"shed with ServeDeadlineError; SERVE_STATS deltas {d}")
        svc.close(SERVE_TIMEOUT)

        # ---- clean monitor ticks, each with its probe ms; device_loss cannot fire on one card
        mon = rz.HealthMonitor(interval_s=0.0)
        rz.reset_health_stats()
        ticks = [mon.tick() for _ in range(MON_TICKS)]
        check(all(not (t.degraded or t.failed or t.stragglers) for t in ticks)
              and rz.HEALTH_STATS["probe_failures"] == 0, f"[serve] monitor ticks {rz.HEALTH_STATS}")
        with rz.FaultSchedule([("supervisor.step", 1, "device_loss")]) as fs:
            rz.supervise(lambda st, data, step: (st, True), {"n": 0}, n_steps=1)
        check(fs.pending() == [("supervisor.step", 1, "device_loss")], "[serve] device_loss fired on one card")
        say(f"{MON_TICKS} clean monitor ticks, probe ms " + ", ".join(f"{t.probe_ms:.4f}" for t in ticks)
            + f"; HEALTH_STATS {dict(rz.HEALTH_STATS)}; device_loss stays pending on one card")
        for name in ("moments_onepass", "lloyd_fused", "topk_distance", "threefry_bits"):
            check(path_launches.get(name, 0) > 0, f"[serve] {name} was not launched on the path: {path_launches}")
        say(f"path launches {path_launches}")
        del z, train, clf, km, km_r, clean, served
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[serve] phase {time.perf_counter() - t_phase:.1f} s host ({smi})", flush=True)
    return path_launches


def _dist_serve(ht, world, rank, timed, same_everywhere, say, out_dir, seed):
    """[dist]'s serve steps: a supervised KMeans fit at N_MAIN x 32 rows a card that loses a rank at step 3
    (device_loss: every rank marks the same rank, the survivors' group is built member-only, the lost rank
    detaches); then the ServeService with the replicated tick armed, every rank playing the same trace, with a
    device_loss at a dispatch (the models moved onto the survivors, the in-flight batch redispatched, the excluded
    rank answering with DegradeError) healed and grown back by the health monitor, and a device_flap on one rank
    that degrades, heals and grows back. Returns what the parent compares and prints."""
    import numpy as np
    import torch

    from heat_tpu_torch.core import _hooks

    rz = ht.resilience
    comm = ht.get_comm()
    out = {"steps": {}}
    _, _, x, _, _ = _dist_data(ht, world)
    z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
    del x
    init = z[:K_MAIN].resplit(None)
    lost = 1 if world > 1 else None  # the schedule's first draw, 0.844: healthy[int(0.844 * 997) % world]
    d = os.path.join(out_dir, "supervised")
    (km, n_sup, rc, t_sup, fs), host, ev = timed(lambda: serve_fits(
        ht, z, init, d, [("supervisor.step", SUP_FAULT_STEP + 1, "device_loss")], say, "supervised fit"))
    res = km.supervisor_result_
    sizes = (comm.size, res.comm.size if res.comm is not None else None)
    if world > 1:
        check([i.kind for i in fs.injected] == ["device_loss"] and res.detached == (rank == lost)
              and sizes[1] == world - 1, f"[dist] supervised fit: detached {res.detached}, sizes {sizes}")
    else:
        check(fs.pending() and not res.detached, "[dist] device_loss fired on one card")
    out["sup_detached"] = res.detached
    out["sup_centers"] = None if res.detached else km.cluster_centers_.larray.cpu()
    out["sup"] = {"launches": n_sup, "recovery": rc, "host_s": host, "sizes": sizes}
    rz.clear_unhealthy()
    ht.use_comm(comm)
    say(f"supervised fit (device_loss at step {SUP_FAULT_STEP}): group {sizes[0]} -> {sizes[1]}, "
        f"{'detached' if res.detached else 'finished'}, {n_sup} lloyd_fused launches, {host:.4f} s host")
    del km
    torch.cuda.empty_cache()

    # ---- the service: the models, the references, the trace
    clean = ht.cluster.KMeans(n_clusters=K_MAIN, init=init, max_iter=ITERS, tol=None).fit(z)
    served = ht.cluster.KMeans(n_clusters=K_MAIN).load_state_dict(
        {k: v for k, v in clean.state_dict().items() if k not in ("labels", "labels_split")})
    train = z[:N_TRAIN]
    clf = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, clean.labels_[:N_TRAIN])
    trace = serve_trace(seed + SERVE_SEED_OFFSET, N_DIST_SERVE_REQ)
    refs = serve_references(ht, served, clf, trace)
    tail = serve_trace(seed + SERVE_SEED_OFFSET + 2, 64)
    tail_refs = serve_references(ht, served, clf, tail)
    events, held = [], []

    def groups_held():
        from torch.distributed import distributed_c10d

        return len(distributed_c10d._world.pg_names) if torch.distributed.is_initialized() else 0

    def on_event(event, ctx):
        if event in ("serve.shrink", "serve.grow"):
            events.append((event.split(".")[1], ctx.get("old"), ctx.get("new")))
            free, total = torch.cuda.mem_get_info()
            held.append((groups_held(), (total - free) / 2**20))  # after each resize: process groups, MiB in use

    held0 = groups_held()

    _hooks.add_observer(on_event)
    culprit = min(2, world - 1)
    mon = rz.HealthMonitor(interval_s=DIST_MON_S, heal_after=DIST_HEAL_AFTER)
    svc = serve_service(ht, served, clf, autoscaler=ht.serve.Autoscaler(mon))
    ht.kernels.reset_kernel_stats()
    def wait_for(n_events):  # the dispatcher applies the replicated verdicts; this thread only watches
        t0 = time.perf_counter()
        while (len(events) < n_events or ht.get_comm().size != world) and time.perf_counter() - t0 < DIST_SERVE_WAIT:
            time.sleep(0.01)

    try:
        serve_warm(ht, svc, SERVE_MAX_BATCH)
        with rz.FaultSchedule([("serve.dispatch", 8, "device_loss")]) as fs:
            answers, reqs, stats, launches, secs = serve_play(ht, svc, trace)
            if world > 1:
                wait_for(2)  # the loss's shrink, then the grow once the monitor healed the rank
        pending = fs.pending()
        if world > 1:
            with rz.FaultSchedule([("monitor.probe", 2, "device_flap")] if rank == culprit else []) as fs2:
                wait_for(4)  # the flap's shrink and grow
            pending += fs2.pending()
        tail_ans, tail_reqs, tail_stats, _, _ = serve_play(ht, svc, tail)
    finally:
        svc.close(SERVE_TIMEOUT)
        _hooks.remove_observer(on_event)
        rz.clear_unhealthy()
        ht.use_comm(comm)
    check(all(r.answers == 1 for r in reqs + tail_reqs), "[dist] a served request was answered more than once")
    n_ok, n_err, km_ties, knn_ties = serve_verify(ht, "[dist] serve", served, clf, train, trace, answers, refs,
                                                  allow=(rz.DegradeError,) if rank == lost else ())
    tail_ok, _, _, _ = serve_verify(ht, "[dist] serve tail", served, clf, train, tail, tail_ans, tail_refs)
    if world > 1:
        check(not pending and events[:2] == [("shrink", world, world - 1), ("grow", world - 1, world)]
              and events[2:4] == [("shrink", world, world - 1), ("grow", world - 1, world)],
              f"[dist] serve: group events {events}, pending {pending}")
        check((n_err > 0) == (rank == lost), f"[dist] serve: {n_err} DegradeErrors on rank {rank}")
        check(held[0][0] == held0, f"[dist] serve: the loss's shrink to the fit's survivors built a group "
                                   f"({held0} -> {held[0][0]} held)")
    else:
        check(pending == [("serve.dispatch", 8, "device_loss")] and not events, f"[dist] one card: {pending} {events}")
    out["serve"] = {"rows": n_ok, "errors": n_err, "ties": (km_ties, knn_ties), "events": events,
                    "secs": secs, "stats": {k: v for k, v in stats.items() if v}, "launches": launches,
                    "collectives": {k: dict(v) for k, v in ht.kernels.COLLECTIVES.items()}, "tail_rows": tail_ok,
                    "groups_held": [held0] + [g for g, _ in held]}
    say(f"serve: {len(trace)} requests in {secs:.4f} s ({len(trace) / secs:.2f} requests/s), rows {n_ok}, "
        f"DegradeError {n_err}, near-tie rows {km_ties}/{knn_ties}; group events {events}; process groups held "
        f"before the trace {held0}, after each event {[g for g, _ in held]}, device MiB in use after each event "
        f"(torch.cuda.mem_get_info) {[round(m, 1) for _, m in held]}; then {tail_ok} of "
        f"{len(tail)} requests answered with rows on {world} card(s); SERVE_STATS {out['serve']['stats']}; "
        f"LAUNCHES {launches}; COLLECTIVES {out['serve']['collectives']}")
    del z, train, clf, clean, served
    torch.cuda.empty_cache()
    return out


# ---- [lazy]: heat_tpu's captured chains (tests/test_lazy.py's CHAINS) at [main]'s width on one card
LAZY_SEED_OFFSET = 600       # [lazy]'s and [dist]'s lazy steps draw their torch streams from --seed + this
# every chain, the elementwise one's expf included, is held bit for bit: the kernel and torch's exp kernel both
# call CUDA's expf, and on an H100 they agreed to 0 ulp, kernel vs plain and fused vs eager, in every run of [lazy]
N_DIST_LAZY = 1 << 22        # [dist]'s lazy chain: rows of 32 float32 per card


def lazy_chains(ht):
    """heat_tpu's chains (tests/test_lazy.py:52-60), each one result; cumsum_inner left out as a variant of cumsum."""
    return {
        "standardize": lambda x: (x - ht.mean(x, axis=0)) / (ht.std(x, axis=0) + 1.0),
        "score": lambda x: ht.sum((x * x - 1.0) * 0.5, axis=0),
        "elementwise": lambda x: ht.exp(-ht.abs(x)) * 2.0 + 1.0,
        "mean_all": lambda x: x - ht.mean(x),
        "var_norm": lambda x: x / (ht.var(x, axis=0) + 1.0),
        "cumsum": lambda x: ht.cumsum(x * 3.0, axis=0),
    }


def ulp_dist32(a, b):
    """The largest distance of two float32 tensors in units in the last place (0 where equal)."""
    import torch

    ia, ib = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(1 << 31) - ia, ia)
    ib = torch.where(ib < 0, -(1 << 31) - ib, ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def lazy_record(lev):
    """Install a recorder of every ``lazy_fused`` call the plans make: (program, inputs, shape, reduce (False: no
    terminal sum), outputs)."""
    calls = []
    orig = lev.lazy_fused

    def rec(prog, inputs, shape, reduce=False):
        outs = orig(prog, inputs, shape, reduce)
        calls.append((prog, list(inputs), tuple(shape), reduce, outs))
        return outs

    lev.lazy_fused = rec
    return calls, orig


def lazy_sum_bound(prog, inputs, shape, reduce, plain):
    """How far a terminal sum of the kernel (double sums of the values rounded to their type, then one rounding)
    may lie from the plain version's torch.sum of the stored values: twice Higham and Mary's probabilistic bound
    SUM_LAMBDA sqrt(n) u sum |v| over the summed axis (n its terms; the worst case gamma_n sum |v| is void at
    n u >= 1, as at 2^24 float32 rows), plus two roundings of the sum."""
    import torch

    from heat_tpu_torch.core.kernels import lazy_fused_plain

    (vals,) = lazy_fused_plain(prog, inputs, shape)
    a = vals.abs().double()
    scale = a.sum() if reduce is None else a.sum(dim=reduce, keepdim=True)
    n = vals.numel() if reduce is None else vals.shape[reduce]
    u = F32_UNIT_ROUNDOFF if vals.dtype == torch.float32 else 2.0 ** -53
    return 2 * SUM_LAMBDA * math.sqrt(n) * u * scale.reshape(plain.shape) + 2 * u * plain.abs().double()


def lazy_sum_ratio(got, prog, inputs, shape, reduce):
    """How far the kernel's terminal sum ``got`` lies from the plain version's stored values summed in float64,
    as a share of its bound. The kernel adds the same rounded values in double and rounds once, so the two
    double sums of the n terms are each within gamma_n(2^-53) sum |v| of the exact one, and the one rounding
    to the output's type is within half an ulp: the bound is one ulp of the output's type (2 u |ref|) plus
    2 gamma_n(2^-53) sum |v|. A dropped partial or chunk shows at once, as the share of the sum it held."""
    import torch

    from heat_tpu_torch.core.kernels import lazy_fused_plain

    (vals,) = lazy_fused_plain(prog, inputs, shape)
    v = vals.double()
    del vals
    ref = v.sum() if reduce is None else v.sum(dim=reduce, keepdim=True)
    scale = v.abs_().sum() if reduce is None else v.abs_().sum(dim=reduce, keepdim=True)
    del v
    n = math.prod(shape) if reduce is None else shape[reduce]
    g64 = n * 2.0 ** -53 / (1 - n * 2.0 ** -53)
    u = F32_UNIT_ROUNDOFF if got.dtype == torch.float32 else 2.0 ** -53
    bound = (2 * u * ref.abs() + 2 * g64 * scale).clamp_(min=1e-300).reshape(got.shape)
    return ((got.double() - ref.reshape(got.shape)).abs() / bound).max().item()


def lazy_ptxas(kernel_lines, reg64):
    """The ptxas report of csrc/lazy_fused.cu's kernel on a float (or double) register file: (registers, stack
    frame bytes, spill store bytes, spill load bytes)."""
    import re

    entry = "lazy_fused_kernelIdE" if reg64 else "lazy_fused_kernelIfE"
    regs = stack = stores = loads = None
    seen = False
    for line in kernel_lines:
        if "Compiling entry function" in line:
            seen = entry in line
        elif seen and "stack frame" in line and stack is None:
            stack, stores, loads = (int(v) for v in re.findall(r"(\d+) bytes", line)[:3])
        elif seen and "Used" in line and regs is None:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
    return regs, stack, stores, loads


def lazy_sweep(dev, smi):
    """The sweep of tools/lazy_fused_probe.py in [lazy]: programs of 1-32 add/mul instructions with immediates on
    one flat 2^24 x 32 float32 input, with their first 0-2 instructions adding a broadcast row, each timed (CUDA
    events) against the bytes bound and checked bit for bit against lazy_fused_plain at (2^20 + 7) x 32 (a tail
    tile); the least-squares ms an instruction (all, and up to 8) and the ms a row. Returns the timed rows."""
    import torch

    from heat_tpu_torch.core.kernels import lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import SegmentProgram, describe
    from tools.lazy_fused_probe import fit_slope, sweep_programs

    gen = torch.Generator(device=dev)
    gen.manual_seed(LAZY_SEED_OFFSET + 19)
    x = torch.randn(N_MAIN, F_MAIN, device=dev, generator=gen)
    rows = [torch.randn(1, F_MAIN, device=dev, generator=gen), torch.randn(1, F_MAIN, device=dev, generator=gen)]
    xt = torch.randn((1 << 20) + 7, F_MAIN, device=dev, generator=gen)
    bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    out = []
    for k, r, prog in sweep_programs(SegmentProgram, torch):
        tail = [xt] + rows[:r]
        (got,) = lazy_fused(prog, tail, tuple(xt.shape))
        (want,) = lazy_fused_plain(prog, tail, tuple(xt.shape))
        check(torch.equal(got, want), f"[lazy] sweep {k} instructions, {r} rows: lazy_fused vs plain at the tail size")
        del got, want
        ins = [x] + rows[:r]
        ms = time_ms(lambda: lazy_fused(prog, ins, (N_MAIN, F_MAIN)), reps=10, warm=2)
        d = describe(prog, ins, (N_MAIN, F_MAIN))
        out.append((k, r, ms))
        print(f"[time] lazy_fused sweep: {k} instructions, {r} broadcast rows: kernel_ms {ms:.4f} bound_ms {bound:.4f} "
              f"(share {bound / ms:.3f}); routes {d['routes']}, {d['blocks_per_sm']} blocks per SM; bit for bit at "
              f"(2^20 + 7) x 32 ({smi})", flush=True)
    fits = {r: (fit_slope([(k, ms) for k, rr, ms in out if rr == r]),
                fit_slope([(k, ms) for k, rr, ms in out if rr == r and k <= 8])) for r in (0, 1, 2)}
    per_row = sorted(m1 - m0 for k0, r0, m0 in out if r0 == 0 for k1, r1, m1 in out if r1 == 1 and k1 == k0)
    print("[time] lazy_fused sweep fit: ms an instruction (1-32; up to 8) / intercept: " + "; ".join(
        f"{r} rows {a[0]:.4f} ({b[0]:.4f}) / {a[1]:.4f}" for r, (a, b) in fits.items())
        + f"; a broadcast row {per_row[len(per_row) // 2]:.4f} ms (median over k) ({smi})", flush=True)
    del x, xt, rows
    torch.cuda.empty_cache()
    return out


def lazy_host_us(ht, dev, mu, sd, smi):
    """The warm host microseconds of one lazy_fused call (the median of 400, no synchronise inside) at the serve
    buckets of 1 and 256 rows of (rows - mu) / sd, the endpoint's fused segment."""
    import statistics

    import torch

    from heat_tpu_torch.core.kernels import lazy_fused
    from heat_tpu_torch.core.lazy import evaluate as lev

    gen = torch.Generator(device=dev)
    gen.manual_seed(LAZY_SEED_OFFSET + 256)
    host = {}
    for b in (1, 256):
        rows_t = ht.array(torch.randn(b, F_MAIN, device=dev, generator=gen))
        calls, orig = lazy_record(lev)
        try:
            with ht.lazy():
                r = (rows_t - mu) / sd
            r.larray
        finally:
            lev.lazy_fused = orig
        (prog, inputs, shape, reduce, _), = calls
        for _ in range(50):
            lazy_fused(prog, inputs, shape, reduce)
        torch.cuda.synchronize()
        us = []
        for i in range(400):
            t0 = time.perf_counter()
            lazy_fused(prog, inputs, shape, reduce)
            us.append((time.perf_counter() - t0) * 1e6)
            if i % 50 == 49:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        host[b] = statistics.median(us)
    print(f"[lazy] host: one warm lazy_fused call at the serve buckets of 1 and 256 rows: {host[1]:.2f} and "
          f"{host[256]:.2f} us (median of 400; the plan cached, its pointers and immediates patched) ({smi})",
          flush=True)
    return host


def lazy_phase(dev, seed, smi):
    """[lazy]: the lazy layer on [main]'s 2^24 x 32 float32 blobs (2 GiB), split 0. heat_tpu's chains run captured
    (``ht.lazy()``) and eagerly; the standardized result goes into KMeans.fit (``lloyd_fused``); a ServeService
    serves an ``@ht.fuse`` endpoint argmax(((x - mu) / sd) @ w, axis=1), warm across its buckets. Counts are zeroed
    just before that path and read just after. Then, off the path: every chain's ``lazy_fused`` segments against
    ``lazy_fused_plain`` on their own inputs (bit for bit; a segment with a terminal sum, ``score``'s, against
    the plain version's stored values summed in float64, see :func:`lazy_sum_ratio`), the fused result against
    the eager one (bit for bit; a fused sum within :func:`lazy_sum_bound`),
    cold and warm host seconds of both, the kernel's CUDA-event ms against its bytes bound, the eager chain's ms as
    context (its cumsum through ``scan_axis``), launches per chain, and the warm call's budget (1 fused dispatch, 1
    cache hit, no graph captured, no build or plan in a Region). Returns the lazy_fused row of the kernels line and
    the path's launches."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.analysis import Region
    from heat_tpu_torch.core.kernels import _build, lazy_fused, lazy_fused_plain
    from heat_tpu_torch.core.kernels.lazy_fused import MAX_SLOTS_F64, describe, segment_bytes
    from heat_tpu_torch.core.lazy import evaluate as lev

    ht.use_device("gpu")
    report = _build.build_all()["lazy_fused"].ptxas
    ptxas = {reg64: lazy_ptxas(report, reg64) for reg64 in (False, True)}
    for reg64, (regs, stack, stores, loads) in ptxas.items():
        print(f"[design] lazy_fused kernel on a {'double' if reg64 else 'float'} register file: ptxas {regs} registers, "
              f"{stack} bytes stack frame, {stores} / {loads} bytes spill stores / loads", flush=True)
        check(regs is not None and stack == 0 and stores == 0 and loads == 0,
              f"[lazy] lazy_fused's ptxas report: stack frame {stack}, spills {stores} / {loads}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + LAZY_SEED_OFFSET)
    centres = torch.randn(K_MAIN, F_MAIN, device=dev, generator=gen) * 4.0
    member = torch.arange(N_MAIN, device=dev) % K_MAIN
    xa = centres[member] + torch.randn(N_MAIN, F_MAIN, device=dev, generator=gen)
    del member
    x = ht.array(xa, split=0, copy=False)
    w = ht.array(torch.randn(F_MAIN, K_MAIN, device=dev, generator=gen))
    chains = lazy_chains(ht)
    eager_cold = {}
    for name, chain in chains.items():  # eager first: its cold call pays no lazy planning
        t0 = time.perf_counter()
        chain(x)
        torch.cuda.synchronize()
        eager_cold[name] = time.perf_counter() - t0
    mu, sd = ht.mean(x, axis=0), ht.std(x, axis=0)

    @ht.fuse
    def score(rows):
        return ht.argmax(((rows - mu) / sd) @ w, axis=1)

    # ---- the path, counts zeroed just before and read just after
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    ht.reset_fuse_stats()
    t_path = time.perf_counter()
    fused, fused_cold = {}, {}
    for name, chain in chains.items():
        t0 = time.perf_counter()
        with ht.lazy():
            fused[name] = chain(x)
        torch.cuda.synchronize()
        fused_cold[name] = time.perf_counter() - t0
    z = fused["standardize"]
    km = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
    svc = ht.serve.ServeService(ht.serve.BucketPolicy(max_batch=SERVE_MAX_BATCH, max_latency_ms=SERVE_LATENCY_MS))
    svc.register_endpoint("fused.score", score)
    rng = np.random.default_rng(seed + LAZY_SEED_OFFSET)
    buckets, answers = [], []
    b = 1
    while b <= SERVE_MAX_BATCH:
        rows = (rng.normal(size=(b, F_MAIN)) * 4.0).astype(np.float32)
        r = svc.submit("fused.score", rows)
        svc.flush()
        answers.append((rows, r.result(SERVE_TIMEOUT)))
        buckets.append(b)
        b *= 2
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches, stats, fuse_path = dict(ht.LAUNCHES), dict(ht.KERNEL_STATS), dict(ht.FUSE_STATS)
    print(f"[lazy] path {path_s:.3f} s: launches {launches} KERNEL_STATS {stats} FUSE_STATS {fuse_path}", flush=True)
    check(launches["lazy_fused"] >= len(chains) + len(buckets), f"[lazy] lazy_fused launches {launches}")
    check(launches["lloyd_fused"] == ITERS + 1, f"[lazy] lloyd_fused launches {launches}")
    # every call launched the kernel (a summed segment twice: checked exactly after the chains' replays below)
    check(launches["lazy_fused"] >= stats.get("lazy_fused.cuda", 0) >= len(chains) + len(buckets)
          and "lazy_fused.torch" not in stats, f"[lazy] lazy_fused routes {stats}")
    check(fuse_path["eager_fallbacks"] == 0 and fuse_path["fused_dispatches"] == len(chains) + len(buckets),
          f"[lazy] FUSE_STATS on the path {fuse_path}")
    cw = km.cluster_centers_.larray
    check(tuple(cw.shape) == (K_MAIN, F_MAIN) and bool(torch.isfinite(cw).all()), "[lazy] KMeans centres")

    # ---- the served answers against the eager function, then the warm buckets' budget
    for rows, got in answers:
        t = ht.array(torch.from_numpy(rows).to(dev))
        want = ht.argmax(((t - mu) / sd) @ w, axis=1).numpy()
        check(np.array_equal(np.asarray(got).reshape(-1), want), f"[lazy] served rows {rows.shape[0]}")
    ht.reset_fuse_stats()
    r_serve = Region("warm buckets")
    for b in buckets:
        svc.submit("fused.score", rng.normal(size=(b, F_MAIN)).astype(np.float32))
        svc.flush()
    svc.close(SERVE_TIMEOUT)
    check(ht.FUSE_STATS["fused_dispatches"] == len(buckets) == ht.FUSE_STATS["cache_hits"]
          and ht.FUSE_STATS["graphs_captured"] == 0 and r_serve.compiles == 0 and r_serve.traces == 0,
          f"[lazy] warm buckets: FUSE_STATS {ht.FUSE_STATS}, region {r_serve.stats()}")
    print(f"[lazy] served {len(buckets)} buckets {buckets}: answers equal to eager; warm pass {dict(ht.FUSE_STATS)}, "
          f"region {r_serve.stats()}", flush=True)
    del km, z, svc

    # ---- every chain: fused vs eager, kernel vs plain, times, the warm budget
    err_max, elem, summed_row, path_sums = 0.0, None, None, 0
    for name, chain in chains.items():
        eager = chain(x)
        ea, fa = eager.larray, fused[name].larray
        d = ulp_dist32(fa, ea)
        calls, orig = lazy_record(lev)
        try:
            ht.reset_fuse_stats()
            region = Region(f"warm {name}")
            l0, s0 = ht.LAUNCHES["lazy_fused"], ht.LAUNCHES["scan_axis"]
            t0 = time.perf_counter()
            with ht.lazy():
                warm = chain(x)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            per_chain, scans = ht.LAUNCHES["lazy_fused"] - l0, ht.LAUNCHES["scan_axis"] - s0
        finally:
            lev.lazy_fused = orig
        summed = [c for c in calls if c[3] is not False]
        path_sums += len(summed)  # the plan is the path's: its cold call ran the same segments
        if summed:  # a terminal sum: the kernel's double sum of the rounded values, torch.sum's in float32
            (prog, inputs, shape, reduce, _), = summed
            r_fe = ((fa.double() - ea.double()).abs() / lazy_sum_bound(prog, inputs, shape, reduce, ea)).max().item()
            check(fa.shape == ea.shape and r_fe <= 1.0, f"[lazy] {name}: fused vs eager {r_fe} of the sum's bound")
            fe_line = f"fused vs eager {r_fe:.4f} of the sum's bound ({d} ulp)"
        else:
            check(fa.shape == ea.shape and d == 0, f"[lazy] {name}: fused vs eager {d} ulp")
            fe_line = f"fused vs eager {d} ulp"
        check(ht.FUSE_STATS["fused_dispatches"] == 1 and ht.FUSE_STATS["cache_hits"] == 1
              and ht.FUSE_STATS["graphs_captured"] == 0 and region.compiles == 0 and region.traces == 0,
              f"[lazy] {name} warm call: FUSE_STATS {ht.FUSE_STATS}, region {region.stats()}")
        check(torch.equal(warm.larray, fa), f"[lazy] {name}: the warm call differs from the cold one")
        check(per_chain == len(calls) + len(summed) and calls, f"[lazy] {name}: {per_chain} launches, {len(calls)} "
                                                               f"segments, {len(summed)} summed (two launches)")
        t0 = time.perf_counter()
        chain(x)
        torch.cuda.synchronize()
        eager_warm = time.perf_counter() - t0
        seg_ms = seg_plain = seg_bound = 0.0
        for prog, inputs, shape, reduce, outs in calls:
            d = describe(prog, inputs, shape, reduce)
            regs, stack, _, _ = ptxas[d["file"] == "double"]
            print(f"[design] lazy_fused {name}: {len(prog.instrs)} instructions on a {d['file']} register file, "
                  f"{d['mode']}; input routes {d['routes']}; tile {d['tile']} ({d['threads']} threads x "
                  f"{d['per_thread']}), {d['stages']} ring stages, {d['out_bufs']} output staging tile(s), "
                  f"{d['kept_slots']} kept slot(s), {d['smem']} B shared memory, {d['blocks_per_sm']} blocks per SM, "
                  f"grid {d['grid']}; ptxas {regs} registers, {stack} bytes stack frame", flush=True)
            plain = lazy_fused_plain(prog, inputs, shape, reduce)
            for o, p in zip(outs, plain):
                if reduce is not False:
                    r_kp = lazy_sum_ratio(o, prog, inputs, shape, reduce)
                    check(r_kp <= 1.0, f"[lazy] {name}: summed lazy_fused vs the plain values' float64 sum "
                                       f"{r_kp} of one ulp plus the double sums' bound")
                    fe_line += (f"; summed segment vs the plain values' float64 sum {r_kp:.4f} of one ulp plus "
                                f"2 gamma_n(2^-53) sum|v|")
                elif o.dtype == torch.float32:
                    du = ulp_dist32(o, p)
                    check(du == 0, f"[lazy] {name}: lazy_fused vs lazy_fused_plain {du} ulp")
                    err_max = max(err_max, (o - p).abs().max().item())
                else:
                    check(torch.equal(o, p), f"[lazy] {name}: lazy_fused vs plain ({o.dtype})")
            seg_ms += time_ms(lambda: lazy_fused(prog, inputs, shape, reduce), reps=10, warm=2)
            seg_plain += time_ms(lambda: lazy_fused_plain(prog, inputs, shape, reduce), reps=5, warm=1)
            # a summed segment writes its sums only
            moved = segment_bytes(prog, inputs, shape) if reduce is False else (
                sum(t.numel() * t.element_size() for t in inputs) + sum(o.numel() * o.element_size() for o in outs))
            seg_bound += moved / HBM_BYTES_PER_S * 1e3
        # context only: one call where the eager chain takes seconds
        eager_ms = time_ms(lambda: chain(x), reps=1, warm=0) if eager_warm > 1.0 else time_ms(lambda: chain(x), reps=5,
                                                                                               warm=1)
        print(f"[lazy] {name}: cold host s fused {fused_cold[name]:.4f} eager {eager_cold[name]:.4f}; warm host s fused "
              f"{warm_s:.4f} eager {eager_warm:.4f}; lazy_fused {seg_ms:.4f} ms over {len(calls)} segment(s) "
              f"({[len(p.instrs) for p, *_ in calls]} instructions{', the last with its terminal sum' if summed else ''}"
              f") vs bytes bound {seg_bound:.4f} ms (share {seg_bound / seg_ms:.3f}), plain {seg_plain:.4f} ms; eager "
              f"chain {eager_ms:.4f} ms (context); launches per chain: lazy_fused {per_chain}, scan_axis {scans}; "
              f"{fe_line} ({smi})", flush=True)
        if name == "elementwise":
            (prog, inputs, shape, _, _), = calls
            elem = {"ms": seg_ms, "plain_ms": seg_plain, "bytes": segment_bytes(prog, inputs, shape),
                    "ops": len(prog.instrs) * N_MAIN * F_MAIN, "eager_ms": eager_ms}
        del eager, warm, calls
        torch.cuda.empty_cache()
    check(launches["lazy_fused"] == stats["lazy_fused.cuda"] + path_sums,
          f"[lazy] the path's lazy_fused launches {launches['lazy_fused']}: {stats['lazy_fused.cuda']} calls and "
          f"{path_sums} summed segments (a second launch each)")
    lazy_host_us(ht, dev, mu, sd, smi)
    lazy_sweep(dev, smi)
    # ---- float64 chains of 30 and 60 ops on 2^20 rows: the plan cuts them where the kernel's register file ends
    # (28 double slots), every segment fits and launches, and the result equals eager bit for bit
    x64 = ht.array(xa[: 1 << 20].double(), split=0)
    for steps in (20, 40):
        def long_chain(a, steps=steps):
            for i in range(steps):
                a = a * 1.0078125 + 0.5 if i % 2 else a - 0.25
            return a

        calls, orig = lazy_record(lev)
        try:
            with ht.lazy():
                got = long_chain(x64)
            got = got.larray
        finally:
            lev.lazy_fused = orig
        slots = [p.n_in + len(p.instrs) for p, *_ in calls]
        check(calls and max(slots) <= MAX_SLOTS_F64 and torch.equal(got, long_chain(x64).larray),
              f"[lazy] float64 chain of {steps * 3 // 2} ops: segments of {slots} slots, or differs from eager")
        print(f"[lazy] float64 chain of {steps * 3 // 2} ops: {len(calls)} segment(s) of {slots} slots (at most "
              f"{MAX_SLOTS_F64}), equal to eager bit for bit", flush=True)
        del got, calls
    del x64
    t_bytes = elem["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = elem["ops"] / FP32_FLOP_PER_S * 1e3
    row = {
        "name": "lazy_fused", "route": "cuda", "source": "heat_tpu_torch/core/kernels/csrc/lazy_fused.cu",
        "replaces": "none: heat_tpu/core/lazy/evaluate.py:190 _build_program (XLA's fusion of a captured chain)",
        "launches": launches["lazy_fused"], "max_abs_err": err_max, "ms": elem["ms"], "plain_ms": elem["plain_ms"],
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes the chain; the eager chain's ms is context
    }
    print(f"[time] lazy_fused (the elementwise chain's segment, 2^24 x 32 float32 in and out): kernel_ms "
          f"{row['ms']:.4f} bound_ms {row['bound_ms']:.4f} ({row['bound_by']}; {elem['bytes']} B) plain_ms "
          f"{row['plain_ms']:.4f} eager chain {elem['eager_ms']:.4f} ms (context; library_ms None) launches per "
          f"[lazy] path {row['launches']} ({smi})", flush=True)
    del x, xa, fused
    torch.cuda.empty_cache()
    return row, launches


def _dist_lazy(ht, world, rank, timed, same_everywhere, say, seed):
    """[dist]'s lazy steps: this rank's 2^22 x 32 rows (split 0) through a captured chain with a split-axis
    reduction and the standardize chain inside ``lockstep()``, whose check passes with no divergence; FUSE_STATS
    the same on every rank; both results equal to eager. Then a lockstep_divergence scheduled on rank 1 alone:
    the next check raises LockstepError on every rank (at world size 1 no rank 1 exists and nothing raises)."""
    import numpy as np
    import torch

    from heat_tpu_torch.resilience import LockstepError

    dev = ht.get_device().torch_device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + LAZY_SEED_OFFSET + 1 + rank)
    x = ht.array(torch.randn(N_DIST_LAZY, F_MAIN, device=dev, generator=gen) * 2.0 + 1.0, is_split=0)
    div0 = ht.LOCKSTEP_STATS["divergences"]

    def chain():
        with ht.lazy():
            s = ht.sum((x - 1.25) * 2.75, axis=0)
            z = (x - ht.mean(x, axis=0)) / (ht.std(x, axis=0) + 1.0)
        return s, z

    with ht.analysis.lockstep(check_at_exit=False, deadline=120.0) as ls:
        ht.reset_fuse_stats()
        l0 = ht.LAUNCHES["lazy_fused"]
        (s, z), host, ev = timed(chain)
        fs = dict(ht.FUSE_STATS)
        ls.check("lazy chain")
        events = ls.events
    check(ht.LOCKSTEP_STATS["divergences"] == div0, "[dist] lazy chain: lockstep divergence")
    same_everywhere(torch.tensor(list(fs.values()), device=dev), "FUSE_STATS")
    check(fs["fused_dispatches"] == 1 and fs["eager_fallbacks"] == 0, f"[dist] lazy FUSE_STATS {fs}")
    check(ht.LAUNCHES["lazy_fused"] - l0 >= 1, "[dist] lazy chain launched no lazy_fused")
    s_e = ht.sum((x - 1.25) * 2.75, axis=0)
    z_e = (x - ht.mean(x, axis=0)) / (ht.std(x, axis=0) + 1.0)
    # the sum is a terminal sum (the kernel's double sums of each rank's rows, then the ranks' partials in rank
    # order): within twice accumulation_bound's sum bound of eager's float32 sums over the N global rows (as
    # lazy_sum_bound); z bit for bit
    v = ((x - 1.25) * 2.75).larray.abs().double().sum(dim=0)
    s_bound = 2 * accumulation_bound(N_DIST_LAZY * world, ht.get_comm().allreduce(v)) \
        + 2 * F32_UNIT_ROUNDOFF * s_e.larray.abs().double()
    check(bool(((s.larray.double() - s_e.larray.double()).abs() <= s_bound).all()) and torch.equal(z.larray, z_e.larray),
          "[dist] lazy vs eager")
    same_everywhere(s.larray, "lazy split-axis sum")
    schedule = [("collective.allgather", 1, "lockstep_divergence")] if rank == 1 else []
    with ht.analysis.lockstep(check_at_exit=False, deadline=120.0) as ls:
        with ht.resilience.FaultSchedule(schedule):
            ht.core.communication.ragged_process_allgather(np.arange(3), 0)
        try:
            ls.check("scheduled divergence")
            raised = None
        except LockstepError as e:
            raised = type(e).__name__
    check(raised == ("LockstepError" if world > 1 else None), f"[dist] scheduled divergence raised {raised}")
    say(f"lazy: chain {host:.4f} s host, {ev:.4f} ms events, {events} collective events in lockstep, FUSE_STATS {fs}; "
        f"divergence scheduled on rank 1 -> {raised}")
    del x, s, z, s_e, z_e
    torch.cuda.empty_cache()
    return {"host_s": host, "event_ms": ev, "fuse": fs, "raised": raised}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive heat_tpu_torch's main path on the cards and check every kernel.")
    ap.add_argument("--phases", choices=("all", "dist", "spectral", "linalg", "robust", "dtypes", "stream", "layout",
                                         "train", "frame", "resilience", "serve", "lazy"),
                    default="all", help="all (default): every phase; dist, spectral, linalg, robust, dtypes, stream, "
                                        "layout, train, frame, resilience, serve or lazy: environment, build and that "
                                        "phase only")
    ap.add_argument("--seed", type=int, default=0, help="seed of [dtypes]', [stream]'s, the layout steps', the "
                                                        "training steps' and the frame steps' data (default 0)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import _build

    check(os.path.dirname(os.path.abspath(ht.__file__)) == os.path.join(ROOT, "heat_tpu_torch"),
          f"heat_tpu_torch imported from {ht.__file__}, not from this checkout")
    # the plain versions' matrix products run in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- 1. environment
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] device={kind} count={torch.cuda.device_count()} nvidia-smi=({smi}) torch={torch.__version__} "
          f"cuda={torch.version.cuda} python={sys.version.split()[0]}", flush=True)
    print(smi, flush=True)

    # ---------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.2f} s (parallel nvcc)", flush=True)
    for name, info in sorted(built.items()):
        print(f"[build] {name}: {info.seconds:.2f} s -> {os.path.relpath(info.path, ROOT)}")
        for line in info.ptxas:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build]   {line}")
    check(set(built) >= {"moments", "lloyd", "topk_distance", "panel_update", "threefry", "lazy_fused", "scan"},
          f"built {sorted(built)}")
    from heat_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build()  # the CSV parser and file stream (g++), built here so that no step's time holds it
    print(f"[build] native: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, ROOT)}", flush=True)

    walls = {}

    def phase(name, fn):
        t_phase = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        walls[name] = time.perf_counter() - t_phase
        return out

    kernels = phase("kernels and main paths", lambda: single_card_phases(dev)) if args.phases == "all" else None
    if args.phases in ("all", "spectral"):
        phase("spectral", lambda: spectral_phase(dev))
    if args.phases in ("all", "linalg"):
        phase("linalg", lambda: linalg_phase(dev))
    if args.phases in ("all", "robust"):
        robust_launches = phase("robust", lambda: robust_phase(dev))
        if kernels is not None:
            for row in kernels:
                row["launches_robust"] = robust_launches.get(row["name"], 0)
    if args.phases in ("all", "dtypes"):
        dtypes_launches = phase("dtypes", lambda: dtypes_phase(dev, args.seed, smi))
        if kernels is not None:
            for row in kernels:
                row["launches_dtypes"] = dtypes_launches.get(row["name"], 0)
    if args.phases in ("all", "stream"):
        stream_launches = phase("stream", lambda: stream_phase(dev, args.seed, smi))
        if kernels is not None:
            for row in kernels:
                row["launches_stream"] = stream_launches.get(row["name"], 0)
    if args.phases in ("all", "layout"):
        phase("layout", lambda: layout_phase(dev, args.seed, smi))
    if args.phases in ("all", "train"):
        train_launches = phase("train", lambda: train_phase(dev, args.seed, smi))
        if kernels is not None:
            for row in kernels:
                row["launches_train"] = train_launches.get(row["name"], 0)
    if args.phases in ("all", "frame"):
        frame_launches = phase("frame", lambda: frame_phase(dev, args.seed, smi))
        if kernels is not None:
            for row in kernels:
                row["launches_frame"] = frame_launches.get(row["name"], 0)
    if args.phases in ("all", "resilience"):
        phase("resilience", lambda: resilience_phase(dev, args.seed, smi))
    if args.phases in ("all", "serve"):
        serve_launches = phase("serve", lambda: serve_phase(dev, args.seed, smi))
        if kernels is not None:
            for row in kernels:
                row["launches_serve"] = serve_launches.get(row["name"], 0)
    if args.phases in ("all", "lazy"):
        lazy_row, lazy_launches = phase("lazy", lambda: lazy_phase(dev, args.seed, smi))
        if kernels is not None:
            for row in kernels:
                row["launches_lazy"] = lazy_launches.get(row["name"], 0)
            kernels.append(lazy_row)
        else:
            print(f"[lazy] kernel row {json.dumps(lazy_row)}", flush=True)
    if args.phases in ("all", "dist"):
        layout_launches = phase("dist", lambda: dist_phase(torch.cuda.device_count(), args.seed))
        if kernels is not None:
            for row in kernels:
                row["launches_layout"] = layout_launches.get(row["name"], 0)
    print("[walls] host seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()), flush=True)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def scan_phase(dev, za, errors) -> dict:
    """Phase 5's scan_axis (the port's own kernel, behind cumsum/cumprod) at the main path's (2^24, 32), along
    axis 0 (reduce-then-scan over tiles of rows) and axis 1 (a thread a row), on the standardized z (float32),
    on int32 values (float32's geometry: 16-byte packs of 4 columns) and on int64 values, whose sums wrap:
    integers bit for bit against the plain version; float32 within gamma_m sum_{j<=i} |x_j| of the float64
    scan, m = min(k, d): k = i + 1 terms pass at most k - 1 roundings, and at most d, the kernel's fold depth
    (ScanPlan.fold_depth: its tile's rows, the tiles and the folds across a block; Higham, 2nd ed., 4.2, for
    any order of the roundings), plus the float64 scan's own gamma_m; and within twice gamma_m of the plain
    version at the kernel's tiles (whose depth is at most the same), the largest
    ratio printed; the same bits on a second run. CUDA-event ms beside the bytes bound (one read, one write),
    the plain version (tiles of the kernel's rows) and torch.cumsum (library_ms; along axis 0 one call, it
    takes seconds). Returns the JSON row's numbers (float32, axis 0: the split axis the cumsum of the surface
    and of the layout path scan)."""
    import torch

    from heat_tpu_torch.core.kernels import scan_axis, scan_axis_plain
    from heat_tpu_torch.core.kernels.scan import scan_plan

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ints = {
        "int32": torch.randint(-(1 << 30), 1 << 30, (N_MAIN, F_MAIN), device=dev, generator=gen, dtype=torch.int32),
        "int64": torch.randint(-(1 << 40), 1 << 40, (N_MAIN, F_MAIN), device=dev, generator=gen, dtype=torch.int64),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for axis in (0, 1):
        dims = (1, N_MAIN, F_MAIN) if axis == 0 else (N_MAIN, F_MAIN, 1)
        for name, t in (("float32", za), *ints.items()):
            plan = scan_plan(*dims, t.dtype, sms)
            got = scan_axis(t, axis)
            check(torch.equal(scan_axis(t, axis), got), f"scan_axis {name} axis {axis}: not bit-identical on a rerun")
            plain = scan_axis_plain(t, axis, rows_per_tile=plan.rows)
            if name != "float32":
                check(torch.equal(got, plain), f"scan_axis {name} axis {axis} differs from its plain version")
                err, line = 0.0, "bit for bit with the plain version (sums wrap)"
            else:
                ref = scan_axis_plain(t.double(), axis, rows_per_tile=plan.rows)
                # k terms pass at most k - 1 roundings (a fold with the identity is exact), and at most d
                d = plan.fold_depth()
                kd = torch.arange(1, t.shape[axis] + 1, dtype=torch.float64, device=dev).clamp_(max=d)
                kd = kd.reshape((-1, 1) if axis == 0 else (1, -1))
                g32 = kd * F32_UNIT_ROUNDOFF / (1 - kd * F32_UNIT_ROUNDOFF)
                g64 = kd * 2.0 ** -53 / (1 - kd * 2.0 ** -53)
                scale = scan_axis_plain(t.abs().double(), axis, rows_per_tile=plan.rows).clamp_(min=1e-300)
                r_ref = ((got.double() - ref).abs() / ((g32 + g64) * scale)).max().item()
                del ref
                r_plain = ((got.double() - plain.double()).abs() / (2 * g32 * scale)).max().item()
                del scale, g32, g64, kd
                check(r_ref <= 1.0 and r_plain <= 1.0, f"scan_axis float32 axis {axis}: {r_ref} of gamma_d sum|x| "
                                                       f"from float64, {r_plain} of twice it from the plain version "
                                                       f"(d = {d})")
                err = (got - plain).abs().max().item()
                line = (f"within {r_ref:.4f} of gamma_min(k,d) sum|x| (d = {d}, gamma_d = "
                        f"{d * F32_UNIT_ROUNDOFF / (1 - d * F32_UNIT_ROUNDOFF):.3e}) of the float64 scan "
                        f"and {r_plain:.4f} of twice it of the plain version (max abs {err:.3e})")
            del got, plain
            ms = time_ms(lambda: scan_axis(t, axis), reps=10, warm=2)
            plain_ms = time_ms(lambda: scan_axis_plain(t, axis, rows_per_tile=plan.rows), reps=3, warm=1)
            lib = time_ms(lambda: torch.cumsum(t, axis), reps=1, warm=1) if name == "float32" or axis == 1 else None
            nbytes = 2 * t.numel() * t.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"[time] scan_axis {name} ({N_MAIN}, {F_MAIN}) axis {axis}: {plan.route} route, {plan.tiles} tile(s) "
                  f"of {plan.rows} rows, {plan.vec} column(s) a load, {plan.blocks} blocks; {line}; bit-identical "
                  f"rerun; kernel_ms {ms:.4f} bound_ms {bound_ms:.4f} (bytes: one read and one write; share "
                  f"{bound_ms / ms:.3f}) plain_ms {plain_ms:.4f} torch.cumsum_ms "
                  f"{'not timed' if lib is None else f'{lib:.4f}'}", flush=True)
            if axis == 0 and name == "float32":
                errors["scan_axis"] = err
                out = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, "bytes": nbytes, "ops": t.numel(),
                       "source": "heat_tpu_torch/core/kernels/csrc/scan.cu",
                       "replaces": "none: XLA's scan of jnp.cumsum/cumprod, heat_tpu/core/_operations.py:644"}
    del ints
    torch.cuda.empty_cache()
    return out


def single_card_phases(dev) -> list:
    """Phases 3 to 5 on one card; returns the kernels' rows of the JSON line."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.kernels import (
        assign_stats, chol_block_size, chol_panels, cholesky_local, chunk_moments, forced_mode, knn_tiles,
        lloyd_local, lloyd_route, moments_local, nearest_neighbors_local, resident_smem,
    )
    from heat_tpu_torch.core import random as ht_random
    from heat_tpu_torch.core.kernels import lloyd, panel_update, threefry_bits, threefry_plain, topk_distance
    from heat_tpu_torch.core.kernels.threefry import chunk_layout
    from heat_tpu_torch.core.kernels.scan import scan_plan
    from heat_tpu_torch.spatial.distance import _quadratic_expand

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the checks of lloyd_fused's routes past the resident one draw from their own stream, so
    # every path's data is what it was before they were added
    gen_routes = torch.Generator(device=dev)
    gen_routes.manual_seed(1)
    # the C1 and qr phases draw from a third stream, for the same reason
    gen_new = torch.Generator(device=dev)
    gen_new.manual_seed(2)
    errors = {}

    # ----------------------------------------------- 3. kernels vs plain versions
    for n, f, nv in [(N_MAIN, F_MAIN, N_MAIN), (1_000_003, 18, 999_000), (4099, 1, 4099), (1, 5, 1)]:
        x = torch.randn(n, f, device=dev, generator=gen) * 3.0 + 5.0
        cnt, mean, m2 = moments_local(x, nv)
        cnt0, mean0, m20 = chunk_moments(x, nv)
        torch.cuda.synchronize()
        check(float(cnt) == float(cnt0) == float(nv), f"moments counts {float(cnt)} vs {float(cnt0)} vs {nv}")
        e_mean = (mean - mean0).abs()
        e_m2 = (m2 - m20).abs()
        check(bool((e_mean <= MEAN_ATOL + MEAN_RTOL * mean0.abs()).all()), f"moments mean at {(n, f, nv)}")
        check(bool((e_m2 <= M2_RTOL * m20.abs() + 1e-6).all()), f"moments M2 at {(n, f, nv)}")
        rel_m2 = (e_m2 / m20.abs().clamp(min=1e-30)).max().item()
        print(f"[check] moments_onepass n={n} f={f} n_valid={nv}: count exact, mean max abs {e_mean.max().item():.3e} "
              f"(max rel {(e_mean / mean0.abs().clamp(min=1e-30)).max().item():.3e}), M2 max abs {e_m2.max().item():.3e} "
              f"(max rel {rel_m2:.3e})", flush=True)
        if n == N_MAIN:
            errors["moments_onepass"] = max(e_mean.max().item(), e_m2.max().item())
        del x
    lloyd_shapes = [(s, gen) for s in [(N_MAIN, F_MAIN, K_MAIN, N_MAIN), (1_000_003, 18, 5, 999_000),
                                       (65_536, 64, 64, 65_536), (7, 3, 2, 7)]]
    # past the resident route: f > 128 (the wide fit's shape among them), and k * f > 8192 on both routes
    lloyd_shapes += [(s, gen_routes) for s in [(100_003, 129, 3, 100_000), (65_536, F_WIDE, K_WIDE, 65_000),
                                               (20_000, 1000, 5, 19_000), (5_000, 4097, 3, 4_900),
                                               (65_536, 64, 160, 65_536), (30_000, 64, 400, 29_000)]]
    for (n, f, k, nv), g in lloyd_shapes:
        cen = torch.randn(k, f, device=dev, generator=g) * 8.0
        truth = torch.randint(0, k, (n,), device=dev, generator=g)
        x = cen[truth] + torch.randn(n, f, device=dev, generator=g)
        route = lloyd_route(f, k)
        routed = ht.KERNEL_STATS.get(f"lloyd_fused.{route}", 0)
        sums, counts, labels, inertia = lloyd_local(x, cen, nv)
        check(ht.KERNEL_STATS.get(f"lloyd_fused.{route}") == routed + 1, f"lloyd route {route} not counted at {(n, f, k)}")
        sums0, counts0, labels0, inertia0 = assign_stats(x, cen, nv)
        torch.cuda.synchronize()
        check(bool((counts == counts0).all()), f"lloyd counts at {(n, f, k, nv)}")
        d2 = _quadratic_expand(x[:nv], cen)
        two = torch.topk(d2, min(2, k), dim=1, largest=False).values
        near = (two[:, -1] - two[:, 0]) <= TIE_RTOL * two[:, -1]
        diff = labels[:nv] != labels0[:nv]
        check(not bool((diff & ~near).any()), f"lloyd labels differ outside near-ties at {(n, f, k, nv)}")
        e_sums = (sums - sums0).abs().max().item()
        check(e_sums <= SUMS_RTOL * sums0.abs().max().item(), f"lloyd sums at {(n, f, k, nv)}: {e_sums}")
        e_in = abs(float(inertia) - float(inertia0))
        check(e_in <= INERTIA_RTOL * abs(float(inertia0)), f"lloyd inertia at {(n, f, k, nv)}")
        again = lloyd_local(x, cen, nv)
        check(all(bool((a == b).all()) for a, b in zip(again, (sums, counts, labels, inertia))),
              f"lloyd not bit-identical from run to run at {(n, f, k, nv)}")
        print(f"[check] lloyd_fused ({route}) n={n} f={f} k={k} n_valid={nv}: counts exact, labels differ on {int(diff.sum())} rows "
              f"({int(near.sum())} near-tie rows), sums max abs {e_sums:.3e} (max |sum| {sums0.abs().max().item():.3e}), "
              f"inertia rel {e_in / max(abs(float(inertia0)), 1e-30):.3e}, bit-identical rerun", flush=True)
        if n == N_MAIN:
            errors["lloyd_fused"] = max(e_sums, e_in)
        del x, d2
    lsms = lloyd._sm_count(0)
    lper_sm = lloyd._blocks_per_sm(0, F_MAIN, K_MAIN, True)
    lgrid = lloyd.lloyd_resident_plan(N_MAIN, lsms, lper_sm)
    print(f"[design] lloyd_fused: resident route at n={N_MAIN} f={F_MAIN} k={K_MAIN}: 2 CUDA kernels per call (partial, "
          f"reduce); one-wave grid {lgrid} blocks x {lloyd._TILE} threads ({lper_sm} blocks/SM x {lsms} SMs), each a "
          f"contiguous run of {lloyd._TILE}-row tiles; {lloyd._STAGES} cp.async stages (16-byte copies, rows padded to "
          f"f + 4 floats), {lloyd._STAGES - 1} tiles in flight per block = "
          f"{lper_sm * (lloyd._STAGES - 1) * lloyd._TILE * F_MAIN * 4} B per SM; {resident_smem(F_MAIN, K_MAIN)} B of "
          f"shared memory per block. General route (3 CUDA kernels: assign, scatter, reduce) where f > {lloyd._TILE} "
          f"or the resident block passes 227 KB", flush=True)
    knn_shapes = [(N_QUERY, N_TRAIN, F_MAIN, KNN_K), (1000, 3000, 7, 1), (37, 999, 16, 7), (128, 64, 32, 64),
                  # lists in scratch above MAX_K, and k = m
                  (1000, 20_000, 32, 65), (1000, 20_000, 32, 200), (300, 5000, 7, 1000), (70, 333, 70, 333)]
    # n and m off the 128-row query block and the 64-row y tile, on both copy variants and over one chunk
    knn_shapes += [(N_QUERY + 3, 100_003, f, KNN_K) for f in (1, 7, 32, 70)]
    for n, m, f, k in knn_shapes:
        x = torch.randn(n, f, device=dev, generator=gen)
        y = torch.randn(m, f, device=dev, generator=gen)
        d, i = nearest_neighbors_local(x, y, k)
        d0, i0 = knn_tiles(x, y, k)
        torch.cuda.synchronize()
        check(tuple(i.shape) == (n, k) and i.dtype == torch.int32 and bool(((i >= 0) & (i < m)).all()), "kNN indices")
        e_d, ndiff, worst = knn_check(x, y, d, i, d0, i0)
        again = nearest_neighbors_local(x, y, k)
        check(torch.equal(again[0], d) and torch.equal(again[1], i), f"kNN not bit-identical from run to run at {(n, m, f, k)}")
        print(f"[check] topk_distance n={n} m={m} f={f} k={k}: distances max abs {e_d:.3e}, indices differ on {ndiff} "
              f"entries, all within the rounding bound (largest gap {worst:.3f} of it), bit-identical rerun", flush=True)
        if n == N_QUERY and m == N_TRAIN:
            errors["topk_distance"] = e_d
        del x, y, d, i, d0, i0, again
    sms, knn_per_sm = topk_distance._occupancy(0, F_MAIN, KNN_K)
    nseg, seg_len = topk_distance.knn_plan(N_QUERY, N_TRAIN, KNN_K, sms, knn_per_sm)
    print(f"[design] topk_distance: product route fp32 (CUDA cores; 4 query rows x 16 y rows per thread), 3 CUDA kernels per call "
          f"(row norms, partial, merge); at n={N_QUERY} m={N_TRAIN} f={F_MAIN} k={KNN_K}: "
          f"{-(-N_QUERY // topk_distance._ROWS)} query blocks of {topk_distance._ROWS} rows x {nseg} y-segments of "
          f"{seg_len} rows = {-(-N_QUERY // topk_distance._ROWS) * nseg} blocks ({knn_per_sm} blocks/SM x {sms} SMs); "
          f"y tiles of {topk_distance._YT} rows x 32 columns through 3 cp.async stages (16-byte copies when f % 4 == 0); "
          f"per-row lists in shared memory for k <= {topk_distance.MAX_K}, in the scratch above", flush=True)
    for n in (N_RIDGE, 1000, 129, 33, 32, 31, 1):
        a = spd(n, gen, dev)
        L = cholesky_local(a)
        L0 = chol_panels(a, chol_block_size(n))
        torch.cuda.synchronize()
        e_l = (L - L0).abs().max().item()
        check(e_l <= CHOL_ATOL_REL * L0.abs().max().item(), f"chol vs plain at n={n}: {e_l}")
        check(bool((torch.triu(L, 1) == 0).all()), f"chol upper triangle not zero at n={n}")
        check(torch.equal(cholesky_local(a), L), f"chol not bit-identical from run to run at n={n}")
        recon = (L.double() @ L.double().T - a.double()).abs().max().item() / a.abs().max().item()
        print(f"[check] chol_panel_fused n={n}: vs plain max abs {e_l:.3e} (max |L| {L0.abs().max().item():.3e}), "
              f"||L L^T - A||max/||A||max {recon:.3e}, upper zero, bit-identical rerun", flush=True)
        if n == N_RIDGE:
            errors["chol_panel_fused"] = e_l
    for jf in (700, 704):  # 704 sits on a 32-wide panel's edge
        a = spd(N_RIDGE, gen, dev)
        a[jf, jf] = -50.0  # not positive definite from pivot jf on: NaN, never an error
        L, L0 = cholesky_local(a), chol_panels(a, chol_block_size(N_RIDGE))
        check(torch.equal(torch.isnan(L), torch.isnan(L0)) and bool(torch.isnan(L[jf:, jf]).all())
              and bool(torch.isfinite(L[:, :jf]).all()), f"chol NaN pattern of a non-SPD matrix vs plain (pivot {jf})")
        print(f"[check] chol_panel_fused non-SPD n={N_RIDGE}: NaN mask equal to the plain version's "
              f"({int(torch.isnan(L).sum())} NaN entries, columns >= {jf})", flush=True)
        del a, L, L0
    sms, chol_per_sm = panel_update._occupancy(0)
    print(f"[design] chol_panel_fused: 1 CUDA kernel per call (one cudaLaunchCooperativeKernel), "
          f"cooperative grid {panel_update.chol_grid(N_RIDGE, sms, chol_per_sm)} blocks x {panel_update._THREADS} threads "
          f"at n={N_RIDGE} ({chol_per_sm} blocks/SM x {sms} SMs co-resident), panels of {panel_update._PANEL} columns, "
          f"{-(-N_RIDGE // panel_update._PANEL) + 1} grid barriers (look-ahead: one per panel)", flush=True)
    # threefry_bits, the port's own kernel: every kind bit-identical to its plain version, at the main path's
    # draw (2^24 x 32 normal float32) and beside it; a chunk of a split-1 draw (rows of indices, strided)
    lo32 = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    lo64 = float(np.nextafter(-1.0, 0.0))
    main_draw = (chunk_layout((N_MAIN, F_MAIN), None, 0, 0), "normal32", lo32, 2.0)
    for layout, kind, lo, scale in [main_draw, (chunk_layout((N_MAIN, F_MAIN), None, 0, 0), "uniform32", 0.0, 1.0),
                                    (chunk_layout((1 << 26,), None, 0, 0), "uniform64", 0.0, 1.0),
                                    (chunk_layout((1 << 24,), None, 0, 0), "normal64", lo64, 2.0),
                                    (chunk_layout((N_MAIN,), None, 0, 0), "bits32", 0.0, 1.0),
                                    (chunk_layout((1 << 24,), None, 0, 0), "bits64", 0.0, 1.0),
                                    (chunk_layout((4096, 4099), 1, 1025, 1025), "uniform32", 0.0, 1.0)]:
        got = threefry_bits(THREEFRY_KEY, layout, kind, dev, lo, scale)
        want = threefry_plain(THREEFRY_KEY, layout, kind, dev, lo, scale)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        if kind.startswith("normal"):
            e_tf = (got - want).abs().max().item()
            check(bool(((got - want).abs() <= THREEFRY_NORMAL_RTOL * want.abs()).all()),
                  f"threefry_bits {kind} vs plain beyond 2 ulp: max abs {e_tf}")
            if layout == main_draw[0] and kind == main_draw[1]:
                errors["threefry_bits"] = e_tf
        else:
            check(same, f"threefry_bits {kind} at layout {layout} differs from its plain version")
        print(f"[check] threefry_bits {kind} layout (base, row_stride, rows, cols) {layout}: "
              f"{'bit-identical to the plain version' if same else f'max abs {e_tf:.3e} from the plain version'}",
              flush=True)
        del got, want
    # the permutation KMeans(init="random") takes at n = 2^24: three rounds of 32-bit keys and a stable sort
    perm_key = ht_random._fold_in(ht_random._prng_key(0), 0)
    reset_launches = ht.LAUNCHES["threefry_bits"]
    perm = ht_random._shuffle(perm_key, N_MAIN, dev)
    perm_launches = ht.LAUNCHES["threefry_bits"] - reset_launches
    with forced_mode("threefry_bits", "torch"):
        perm0 = ht_random._shuffle(perm_key, N_MAIN, dev)
    torch.cuda.synchronize()
    check(torch.equal(perm, perm0), "the n = 2^24 permutation differs between threefry_bits and its plain version")
    check(torch.equal(torch.sort(perm).values, torch.arange(N_MAIN, device=dev)), "the permutation is no permutation")
    first_keys = threefry_bits(ht_random._split(perm_key)[1], chunk_layout((N_MAIN,), None, 0, 0), "bits32", dev)
    ties = N_MAIN - torch.unique(first_keys).numel()
    print(f"[check] threefry_bits permutation of arange(2^24) ({perm_launches} kernel launches, one per round): "
          f"identical to the plain version's; {ties} colliding 32-bit keys in the first round, ordered by the "
          f"stable sort", flush=True)
    del perm, perm0, first_keys
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 4. main path
    ht.use_device("gpu")
    member = torch.randint(0, K_MAIN, (N_MAIN + N_PREDICT,), device=dev, generator=gen)
    member[:K_MAIN] = torch.arange(K_MAIN, device=dev)  # rows 0..7: one of each blob, the init rows
    torch.cuda.synchronize()

    # the path starts with its draws: three through threefry_bits (the centres, x, the held-out rows)
    ht.kernels.reset_kernel_stats()
    t_draw = time.perf_counter()
    ht.random.seed(0)
    true_centers = ht.random.randn(K_MAIN, F_MAIN) * 8.0
    x = ht.random.randn(N_MAIN, F_MAIN, split=0) + ht.array(true_centers.larray[member[:N_MAIN]], split=0, copy=False)
    x_new = ht.random.randn(N_PREDICT, F_MAIN, split=0) + ht.array(true_centers.larray[member[N_MAIN:]], split=0, copy=False)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t_draw
    t_main = time.perf_counter()
    mu = ht.mean(x, axis=0)
    sd = ht.std(x, axis=0)
    moments_after_stats = ht.LAUNCHES["moments_onepass"]
    z = (x - mu) / sd
    t_fit = time.perf_counter()
    km = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    pred = km.predict((x_new - mu) / sd)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(ht.LAUNCHES)
    stats = dict(ht.KERNEL_STATS)
    print(f"[main] launches {launches} KERNEL_STATS {stats}", flush=True)
    print(f"[main] draws {draw_s:.3f} s (first calls); mean+std+standardize+fit+predict {main_s:.3f} s; fit "
          f"{fit_s:.3f} s ({ITERS / fit_s:.1f} iterations/s) at n={N_MAIN} f={F_MAIN} k={K_MAIN}", flush=True)
    check(launches["threefry_bits"] == 3 and stats.get("threefry_bits.cuda") == 3,
          f"the path's three draws should each launch threefry_bits once: {launches}, {stats}")
    check(moments_after_stats == 1 and launches["moments_onepass"] == 1,
          f"one moments launch should serve mean and std, got {moments_after_stats}")
    check(stats.get("moments_onepass.cuda") == 2, f"moments dispatches {stats}")
    check(launches["lloyd_fused"] == ITERS + 1, f"lloyd launches {launches['lloyd_fused']} != max_iter + 1")
    check(stats.get("lloyd_fused.cuda") == 1 and not any(k.endswith(".torch") for k in stats), f"dispatch {stats}")
    check(stats.get("lloyd_fused.resident") == ITERS + 1 and "lloyd_fused.general" not in stats,
          f"the main path's Lloyd launches should all take the resident route: {stats}")

    centers = km.cluster_centers_.larray
    check(tuple(centers.shape) == (K_MAIN, F_MAIN) and bool(torch.isfinite(centers).all()), "centers shape/finite")
    check(km.n_iter_ == ITERS and km.labels_.shape == (N_MAIN,) and km.labels_.split == 0, "fit metadata")
    check(km.labels_.larray.dtype == torch.int64 and pred.shape == (N_PREDICT,), "label dtype / predict shape")
    check(mu.shape == (F_MAIN,) and mu.split is None and z.split == 0, "moments shape / split")
    # the fit recovers the standardized blob centres (init row j lies in blob j)
    want = (true_centers.larray - mu.larray) / sd.larray
    rec = (centers - want).abs().max().item()
    check(rec < 1e-2, f"fitted centers are {rec} from the standardized blob centres")
    acc = (pred.larray == member[N_MAIN:]).float().mean().item()
    check(acc > 0.999, f"predict accuracy on held-out rows {acc}")
    print(f"[main] centers within {rec:.3e} of the standardized blob centres; held-out predict accuracy {acc:.6f}; "
          f"inertia {km.inertia_:.6e}", flush=True)

    # the same path through the plain versions, from the same init
    with forced_mode("moments_onepass", "torch"), forced_mode("lloyd_fused", "torch"):
        mu0 = ht.mean(x, axis=0)
        sd0 = ht.std(x, axis=0)
        t0 = time.perf_counter()
        km0 = ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
        torch.cuda.synchronize()
        fit_plain_s = time.perf_counter() - t0
    check(bool(((mu.larray - mu0.larray).abs() <= MEAN_ATOL + MEAN_RTOL * mu0.larray.abs()).all()), "main-path mean vs plain")
    check(bool(((sd.larray - sd0.larray).abs() <= M2_RTOL * sd0.larray.abs()).all()), "main-path std vs plain")
    lab, lab0 = km.labels_.larray, km0.labels_.larray
    d2 = _quadratic_expand(z.larray, km0.cluster_centers_.larray)  # near-ties judged against the plain fit's centres
    two = torch.topk(d2, 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
    ldiff = lab != lab0
    check(not bool((ldiff & ~near).any()), "main-path labels differ from the plain fit outside near-ties")
    cdiff = (centers - km0.cluster_centers_.larray).abs().max().item()
    check(cdiff <= CENTERS_RTOL * km0.cluster_centers_.larray.abs().max().item(), f"centroids vs plain fit: {cdiff}")
    check(abs(km.inertia_ - km0.inertia_) <= INERTIA_RTOL * abs(km0.inertia_), "inertia vs plain fit")
    print(f"[main] vs plain fit: labels differ on {int(ldiff.sum())} rows ({int(near.sum())} near-tie rows), "
          f"centroids max abs {cdiff:.3e}, inertia {km.inertia_:.6e} vs {km0.inertia_:.6e}; plain fit {fit_plain_s:.3f} s",
          flush=True)
    zq = ((x_new - mu) / sd)[:N_QUERY]
    member_q = member[N_MAIN : N_MAIN + N_QUERY]
    del d2, two, near, ldiff, lab0, km0, mu0, sd0, x_new, pred
    torch.cuda.empty_cache()

    # the kNN path: label new points by the fit's clusters
    train, train_labels = z[:N_TRAIN], km.labels_[:N_TRAIN]
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    clf = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, train_labels)
    knn_pred = clf.predict(zq)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    launches["topk_distance"] = ht.LAUNCHES["topk_distance"]
    stats = dict(ht.KERNEL_STATS)
    print(f"[knn] launches {dict(ht.LAUNCHES)} KERNEL_STATS {stats}; fit+predict {knn_s:.3f} s "
          f"({N_QUERY} queries x {N_TRAIN} training rows x f={F_MAIN}, k={KNN_K})", flush=True)
    check(stats.get("topk_distance.cuda") == 1 and "topk_distance.torch" not in stats
          and "topk_distance.fallback" not in stats, f"kNN dispatch {stats}")
    check(launches["topk_distance"] == 1, f"topk_distance launches {launches['topk_distance']}")
    check(knn_pred.shape == (N_QUERY,) and knn_pred.split == 0 and knn_pred.larray.dtype == torch.int64, "kNN predict meta")
    knn_acc = (knn_pred.larray == member_q).float().mean().item()
    check(knn_acc > 0.999, f"kNN predict accuracy against the blobs {knn_acc}")
    with forced_mode("topk_distance", "torch"):
        t0 = time.perf_counter()
        knn_pred0 = clf.predict(zq)
        torch.cuda.synchronize()
        knn_plain_s = time.perf_counter() - t0
        dq0, iq0 = ht.spatial.nearest_neighbors(zq, train, KNN_K)
    dq, iq = ht.spatial.nearest_neighbors(zq, train, KNN_K)
    e_q, nd_q, worst_q = knn_check(zq.larray, train.larray, dq.larray, iq.larray, dq0.larray, iq0.larray)
    pdiff = knn_pred.larray != knn_pred0.larray
    check(not bool((pdiff & ~(iq.larray != iq0.larray).any(dim=1)).any()),
          "kNN labels differ from the plain predict where the neighbours are the same")
    print(f"[knn] accuracy against the blobs {knn_acc:.6f}; vs plain predict ({knn_plain_s:.3f} s): labels differ on "
          f"{int(pdiff.sum())} rows, neighbour indices on {nd_q} entries (all within the rounding bound, largest gap "
          f"{worst_q:.3f} of it), distances max abs {e_q:.3e}",
          flush=True)
    del dq, iq, dq0, iq0, knn_pred0
    # k above the kernel's shared-memory lists: heat_tpu answers any k <= m, and so does the port on a card
    dq, iq = ht.spatial.nearest_neighbors(zq, train, 100)
    dq0, iq0 = knn_tiles(zq.larray, train.larray, 100)
    check(tuple(iq.shape) == (N_QUERY, 100) and iq.larray.dtype == torch.int32, f"nearest_neighbors k=100 {tuple(iq.shape)}")
    e_100, nd_100, worst_100 = knn_check(zq.larray, train.larray, dq.larray, iq.larray, dq0, iq0)
    print(f"[knn] spatial.nearest_neighbors k=100 on the kNN path's data vs knn_tiles: distances max abs "
          f"{e_100:.3e}, indices differ on {nd_100} entries, all within the rounding bound (largest gap "
          f"{worst_100:.3f} of it)", flush=True)
    del dq, iq, dq0, iq0

    # the kernel-ridge path: Cholesky of an RBF Gram matrix, two triangular solves
    X = z[:N_RIDGE]
    yv = ht.array(torch.randn(N_RIDGE, device=dev, generator=gen), split=0)
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    K = ht.spatial.rbf(X, X, sigma=F_MAIN ** 0.5) + 1.0 * ht.eye(N_RIDGE)
    L = ht.linalg.cholesky(K)
    alpha = ht.linalg.solve_triangular(L.T, ht.linalg.solve_triangular(L, yv, lower=True), lower=False)
    torch.cuda.synchronize()
    ridge_s = time.perf_counter() - t0
    launches["chol_panel_fused"] = ht.LAUNCHES["chol_panel_fused"]
    stats = dict(ht.KERNEL_STATS)
    print(f"[ridge] launches {dict(ht.LAUNCHES)} KERNEL_STATS {stats}; rbf+eye+cholesky+2 solves {ridge_s:.4f} s "
          f"at n={N_RIDGE}", flush=True)
    check(stats.get("chol_panel_fused.cuda") == 1 and launches["chol_panel_fused"] == 1, f"ridge dispatch {stats}")
    Kt, Lt, at = K.larray, L.larray, alpha.larray
    check(L.shape == (N_RIDGE, N_RIDGE) and L.split == K.split and alpha.shape == (N_RIDGE,), "ridge shapes / split")
    check(bool(torch.isfinite(Lt).all()) and bool((torch.triu(Lt, 1) == 0).all()), "ridge L finite and lower")
    recon = (Lt.double() @ Lt.double().T - Kt.double()).abs().max().item() / Kt.abs().max().item()
    resid = (torch.linalg.norm(Kt.double() @ at.double() - yv.larray.double()) / torch.linalg.norm(yv.larray.double())).item()
    check(recon <= RIDGE_RECON_RTOL, f"||L L^T - K||max/||K||max = {recon}")
    check(resid <= RIDGE_SOLVE_RTOL, f"||K alpha - y||/||y|| = {resid}")
    with forced_mode("chol_panel_fused", "torch"):
        L0 = ht.linalg.cholesky(K).larray
    e_L = (Lt - L0).abs().max().item()
    check(e_L <= CHOL_ATOL_REL * L0.abs().max().item(), f"ridge L vs plain L: {e_L}")
    check(torch.equal(ht.linalg.cholesky(K).larray, Lt), "ridge L not bit-identical from run to run")
    print(f"[ridge] ||L L^T - K||max/||K||max {recon:.3e}; ||K alpha - y||/||y|| {resid:.3e}; L vs plain L max abs "
          f"{e_L:.3e}; L bit-identical on rerun", flush=True)

    # the surface: elementwise, relational and extrema functions on the KMeans path's standardized z, as a
    # user writes them; only the cumsum launches a kernel of the port (scan_axis: a launch a pass of its plan),
    # counted on their own (launches_surface), not as the main path's
    z_host = z.larray.cpu().numpy()
    s0 = N_MAIN // 2
    zs32 = z_host[s0 : s0 + N_SLICE]
    zs = zs32.astype(np.float64)
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    mask = ht.abs(z) > 3
    surface = {
        "mask": mask, "any": ht.any(mask, axis=1), "sum": ht.sum(mask), "clip": ht.clip(z, -3, 3),
        "where": ht.where(mask, 0.0, z), "min": ht.min(z, axis=0), "max": ht.max(z, axis=0),
        "argmin": ht.argmin(z, axis=0), "argmax": ht.argmax(z, axis=0), "exp": ht.exp(z),
        "log1p_abs": ht.log1p(ht.abs(z)), "sqrt": ht.sqrt(z), "sin": ht.sin(z), "floordiv": z // 1, "mod": z % 1,
        "cumsum": ht.cumsum(z[:N_CUMSUM], axis=0),
    }
    torch.cuda.synchronize()
    surface_s = time.perf_counter() - t0
    surface_launches = dict(ht.LAUNCHES)
    c_plan = scan_plan(1, N_CUMSUM, F_MAIN, torch.float32, torch.cuda.get_device_properties(dev).multi_processor_count)
    c_passes = 1 if c_plan.route == "rows" or c_plan.tiles == 1 else 3  # the tiles' totals, their scan, the tiles'
    check({k: v for k, v in surface_launches.items() if v} == {"scan_axis": c_passes}
          and ht.KERNEL_STATS.get("scan_axis.cuda") == 1,
          f"the surface should launch scan_axis's {c_passes} passes once (its cumsum) and no other kernel: "
          f"{surface_launches}")
    for name, r in surface.items():
        check(r.larray.is_cuda and r.device.device_type == "gpu", f"surface {name} is not on the card")
    host = {k: v.larray[s0 : s0 + N_SLICE].cpu().numpy() for k, v in surface.items()
            if k not in ("sum", "min", "max", "argmin", "argmax", "cumsum")}  # the compared rows
    big = np.abs(zs32) > 3
    exact = {  # bool, int and index results, and the exact float ones, against numpy
        "mask": (host["mask"], big),
        "any": (host["any"], big.any(axis=1)),
        "sum": (surface["sum"].numpy(), np.count_nonzero(np.abs(z_host) > 3)),
        "clip": (host["clip"], np.clip(zs32, -3, 3)),
        "where": (host["where"], np.where(big, np.float32(0), zs32)),
        "min": (surface["min"].numpy(), z_host.min(axis=0)), "max": (surface["max"].numpy(), z_host.max(axis=0)),
        "argmin": (surface["argmin"].numpy(), z_host.argmin(axis=0)),
        "argmax": (surface["argmax"].numpy(), z_host.argmax(axis=0)),
    }
    for name, (got, want) in exact.items():
        check(np.array_equal(got, want), f"surface {name} differs from numpy")
    check(surface["argmin"].larray.dtype == torch.int64 and surface["sum"].larray.dtype == torch.int64, "surface int64 results")
    with np.errstate(invalid="ignore"):
        refs = {"exp": np.exp(zs), "log1p_abs": np.log1p(np.abs(zs)), "sqrt": np.sqrt(zs), "sin": np.sin(zs),
                "floordiv": np.floor(zs), "mod": zs - np.floor(zs)}
    max_ulps = {}
    for name, ref in refs.items():
        max_ulps[name] = float(ulps(host[name], ref).max())
        check(max_ulps[name] <= SURFACE_ULPS, f"surface {name} is {max_ulps[name]} ulp from the float64 value")
    # a prefix of k terms summed with at most m roundings on any term's path is within gamma_m sum|z_i| of the
    # exact prefix (Higham 4.2), m = min(k, d), d the kernel's fold depth at this plan (a fold with the identity
    # is exact, so k terms pass at most k - 1); numpy's float64 cumsum within its own gamma_k
    zc = z_host[:N_CUMSUM].astype(np.float64)
    c_depth = c_plan.fold_depth()
    k = np.arange(1, N_CUMSUM + 1, dtype=np.float64)[:, None]
    m = np.minimum(k, c_depth)
    c_gamma = m * F32_UNIT_ROUNDOFF / (1 - m * F32_UNIT_ROUNDOFF) + k * 2.0 ** -53 / (1 - k * 2.0 ** -53)
    c_gap = np.abs(surface["cumsum"].numpy() - np.cumsum(zc, axis=0))
    c_bound = np.maximum(c_gamma * np.cumsum(np.abs(zc), axis=0), np.finfo(np.float64).tiny)
    check(bool((c_gap <= c_bound).all()), f"surface cumsum beyond gamma_min(k,d) sum|z| (d = {c_depth})")
    print(f"[surface] {len(surface) + 1} calls on z ({N_MAIN} x {F_MAIN}) in {surface_s:.4f} s (host clock, first calls); "
          f"all results on {surface['exp'].larray.device}; kernel launches {dict(ht.LAUNCHES)}; |z| > 3 in "
          f"{int(exact['sum'][1])} entries; mask/any/sum/clip/where/min/max/argmin/argmax "
          f"equal to numpy; max ulp vs float64 on rows {s0}..{s0 + N_SLICE - 1}: "
          + ", ".join(f"{k_} {v:.2f}" for k_, v in max_ulps.items())
          + f"; cumsum of {N_CUMSUM} rows ({c_plan.tiles} tiles of {c_plan.rows} rows) at most "
          f"{(c_gap / c_bound).max():.4f} of its rounding bound gamma_min(k,d) sum|z| (d = {c_depth})", flush=True)
    del surface, host, mask, z_host, exact

    # C1 on the card: the public Cholesky of a matrix that is not positive definite gives jnp's NaN pattern
    # (NaN on and below the diagonal, zeros above) through the kernel
    a_bad = spd(N_RIDGE, gen_new, dev)
    a_bad[700, 700] = -50.0
    ht.kernels.reset_kernel_stats()
    L_bad = ht.linalg.cholesky(ht.array(a_bad, split=0)).larray
    torch.cuda.synchronize()
    check(ht.KERNEL_STATS.get("chol_panel_fused.cuda") == 1 and ht.LAUNCHES["chol_panel_fused"] == 1,
          f"non-SPD cholesky dispatch {dict(ht.KERNEL_STATS)}")
    lower = torch.ones_like(L_bad, dtype=torch.bool).tril()
    check(torch.equal(torch.isnan(L_bad), lower) and bool((L_bad[~lower] == 0).all()),
          "public cholesky of a non-SPD matrix: not NaN on and below the diagonal with zeros above")
    print(f"[c1] linalg.cholesky of spd({N_RIDGE}) with a[700, 700] = -50 on the chol_panel_fused.cuda route: "
          f"{int(torch.isnan(L_bad).sum())} NaN entries = the whole lower triangle, zeros above", flush=True)
    del a_bad, L_bad, lower

    # the wide fit: f = 160 takes lloyd_fused's general route, as heat_tpu's kernel takes any f
    wide_true = torch.randn(K_WIDE, F_WIDE, device=dev, generator=gen_routes) * 8.0
    wide_member = torch.randint(0, K_WIDE, (N_WIDE,), device=dev, generator=gen_routes)
    wide_member[:K_WIDE] = torch.arange(K_WIDE, device=dev)
    xw = ht.array(wide_true[wide_member] + torch.randn(N_WIDE, F_WIDE, device=dev, generator=gen_routes), split=0)
    torch.cuda.synchronize()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    kw = ht.cluster.KMeans(n_clusters=K_WIDE, init=xw[:K_WIDE], max_iter=ITERS_WIDE, tol=None).fit(xw)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    stats = dict(ht.KERNEL_STATS)
    print(f"[wide] launches {dict(ht.LAUNCHES)} KERNEL_STATS {stats}; fit {wide_s:.3f} s at n={N_WIDE} f={F_WIDE} "
          f"k={K_WIDE}, {ITERS_WIDE} iterations", flush=True)
    check(stats.get("lloyd_fused.general") == ITERS_WIDE + 1 and "lloyd_fused.resident" not in stats
          and ht.LAUNCHES["lloyd_fused"] == ITERS_WIDE + 1, f"the wide fit should take the general route: {stats}")
    cw = kw.cluster_centers_.larray
    check(tuple(cw.shape) == (K_WIDE, F_WIDE) and bool(torch.isfinite(cw).all()), "wide fit centers shape/finite")
    with forced_mode("lloyd_fused", "torch"):
        t0 = time.perf_counter()
        kw0 = ht.cluster.KMeans(n_clusters=K_WIDE, init=xw[:K_WIDE], max_iter=ITERS_WIDE, tol=None).fit(xw)
        torch.cuda.synchronize()
        wide_plain_s = time.perf_counter() - t0
    cw0 = kw0.cluster_centers_.larray
    e_cw = (cw - cw0).abs().max().item()
    check(e_cw <= CENTERS_RTOL * cw0.abs().max().item(), f"wide fit centroids vs plain fit: {e_cw}")
    d2 = _quadratic_expand(xw.larray, cw0)
    two = torch.topk(d2, 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
    wdiff = kw.labels_.larray != kw0.labels_.larray
    check(not bool((wdiff & ~near).any()), "wide fit labels differ from the plain fit outside near-ties")
    check(abs(kw.inertia_ - kw0.inertia_) <= INERTIA_RTOL * abs(kw0.inertia_), "wide fit inertia vs plain fit")
    rec_w = (cw - wide_true).abs().max().item()
    check(rec_w < 5e-2, f"wide fit centers are {rec_w} from the blob centres")
    print(f"[wide] vs plain fit ({wide_plain_s:.3f} s): labels differ on {int(wdiff.sum())} rows ({int(near.sum())} "
          f"near-tie rows), centroids max abs {e_cw:.3e}, inertia {kw.inertia_:.6e} vs {kw0.inertia_:.6e}; centers "
          f"within {rec_w:.3e} of the blob centres", flush=True)
    del d2, two, near, wdiff, kw0

    # --------------------------------------------------------------- 5. timing
    xa, za = x.larray, z.larray
    c0 = km.cluster_centers_.larray
    rows = {}
    rows["moments_onepass"] = {
        "ms": time_ms(lambda: moments_local(xa)),
        "plain_ms": time_ms(lambda: chunk_moments(xa, xa.shape[0])),
        "library_ms": time_ms(lambda: torch.var_mean(xa, dim=0, correction=0)),
        # read x once, write count + mean + M2; per element a subtract, an add and a multiply-add
        "bytes": xa.numel() * 4 + (2 * F_MAIN + 1) * 4,
        "ops": 4 * xa.numel(),
        "source": "heat_tpu_torch/core/kernels/csrc/moments.cu",
        "replaces": "heat_tpu/core/kernels/moments.py:90",
    }
    rows["lloyd_fused"] = {
        "ms": time_ms(lambda: lloyd_local(za, c0)),
        "plain_ms": time_ms(lambda: assign_stats(za, c0)),
        "library_ms": None,  # no single PyTorch call computes labels + per-cluster sums + counts + inertia
        # read x and the centers, write labels, sums, counts, inertia; 2 n k f for the distances, n f for the sums
        "bytes": za.numel() * 4 + c0.numel() * 4 + N_MAIN * 4 + (K_MAIN * F_MAIN + K_MAIN + 1) * 4,
        "ops": 2 * N_MAIN * K_MAIN * F_MAIN + N_MAIN * F_MAIN,
        "source": "heat_tpu_torch/core/kernels/csrc/lloyd.cu",
        "replaces": "heat_tpu/core/kernels/lloyd.py:52",
    }
    xwa = xw.larray
    gen_ms, gen_plain_ms = time_ms(lambda: lloyd_local(xwa, cw), reps=10, warm=2), time_ms(lambda: assign_stats(xwa, cw), reps=10, warm=2)
    print(f"[time] lloyd_fused general route at n={N_WIDE} f={F_WIDE} k={K_WIDE}: kernel_ms {gen_ms:.4f} plain_ms "
          f"{gen_plain_ms:.4f} bytes bound_ms {(xwa.numel() + N_WIDE) * 4 / HBM_BYTES_PER_S * 1e3:.4f} (context only; "
          f"the JSON row is the main path's shape)", flush=True)
    del xw, xwa
    ta, tq = train.larray, zq.larray
    rows["topk_distance"] = {
        # 5 launches of a kernel near 0.1 s; the plain version takes seconds: 2 after 1 warm-up
        "ms": time_ms(lambda: nearest_neighbors_local(tq, ta, KNN_K), reps=5, warm=1),
        "plain_ms": time_ms(lambda: knn_tiles(tq, ta, KNN_K), reps=2, warm=1),
        "library_ms": None,  # no single PyTorch call computes a top-k of distances without the matrix
        # read x and y once, write d and idx; 2 n m f flops for the distances
        "bytes": (N_QUERY + N_TRAIN) * F_MAIN * 4 + N_QUERY * KNN_K * 8,
        "ops": 2 * N_QUERY * N_TRAIN * F_MAIN,
        "source": "heat_tpu_torch/core/kernels/csrc/topk_distance.cu",
        "replaces": "heat_tpu/core/kernels/topk_distance.py:65",
    }

    def materialized_topk():
        # the (n, m) matrix is 128 GiB at this shape: 16 slices of 512 query rows
        for r0 in range(0, N_QUERY, 512):
            torch.topk(_quadratic_expand(tq[r0 : r0 + 512], ta), KNN_K, dim=1, largest=False)

    mat_ms = time_ms(materialized_topk, reps=2, warm=1)
    print(f"[time] materializing _quadratic_expand + topk over the kNN path's shape (16 slices of 512 query rows): "
          f"{mat_ms:.4f} ms (context only; not a library_ms)", flush=True)
    rows["chol_panel_fused"] = {
        "ms": time_ms(lambda: cholesky_local(Kt)),
        "plain_ms": time_ms(lambda: chol_panels(Kt, chol_block_size(N_RIDGE)), reps=5, warm=1),
        "library_ms": time_ms(lambda: torch.linalg.cholesky(Kt)),
        # read A once, write L once; n^3 / 3 flops
        "bytes": 2 * N_RIDGE * N_RIDGE * 4,
        "ops": N_RIDGE ** 3 / 3,
        "source": "heat_tpu_torch/core/kernels/csrc/panel_update.cu",
        "replaces": "heat_tpu/core/kernels/panel_update.py:95",
    }
    tf_layout, tf_kind, tf_lo, tf_scale = main_draw
    rows["threefry_bits"] = {
        "ms": time_ms(lambda: threefry_bits(THREEFRY_KEY, tf_layout, tf_kind, dev, tf_lo, tf_scale)),
        "plain_ms": time_ms(lambda: threefry_plain(THREEFRY_KEY, tf_layout, tf_kind, dev, tf_lo, tf_scale), reps=3,
                            warm=1),
        "library_ms": None,  # no PyTorch call draws threefry's bits (torch.randn draws Philox's: context only)
        # nothing read, the (n, f) float32 draw written once; float32 operations per element as counted above
        "bytes": N_MAIN * F_MAIN * 4,
        "ops": THREEFRY_NORMAL_FLOP * N_MAIN * F_MAIN,
        "source": "heat_tpu_torch/core/kernels/csrc/threefry.cu",
        "replaces": "none: jax.random threefry-2x32 in heat_tpu/core/random.py:79 (XLA-fused, not a Pallas kernel)",
    }
    randn_ms = time_ms(lambda: torch.randn(N_MAIN, F_MAIN, device=dev, generator=gen))
    print(f"[time] torch.randn({N_MAIN}, {F_MAIN}) on its Philox generator: {randn_ms:.4f} ms (context only; "
          f"another function, not a library_ms)", flush=True)
    t0 = time.perf_counter()
    ht.cluster.KMeans(n_clusters=K_MAIN, init=z[:K_MAIN], max_iter=ITERS, tol=None).fit(z)
    torch.cuda.synchronize()
    warm_fit_s = time.perf_counter() - t0
    print(f"[time] warm fit {warm_fit_s:.4f} s ({ITERS / warm_fit_s:.1f} iterations/s, {ITERS + 1} lloyd launches)", flush=True)

    rows["scan_axis"] = scan_phase(dev, za, errors)
    kernels = []
    for name in ("moments_onepass", "lloyd_fused", "topk_distance", "chol_panel_fused", "threefry_bits", "scan_axis"):
        r = rows[name]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": errors[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"], "launches_surface": surface_launches[name],
        })
        print(f"[time] {name}: kernel_ms {r['ms']:.4f} bound_ms {bound:.4f} ({kernels[-1]['bound_by']}; "
              f"{r['bytes']} B, {r['ops']} flop) share {bound / r['ms']:.3f} plain_ms {r['plain_ms']:.4f} "
              f"library_ms {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"launches per main path {launches[name]}, on the surface {surface_launches[name]}", flush=True)

    # threefry_bits against its integer operations (the JSON row keeps the bytes / float32 bound of the table)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, check=True).stdout.split()[0])
    int_rate = INT32_OPS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    int_ms = THREEFRY_INT32_OPS * N_MAIN * F_MAIN / int_rate * 1e3
    print(f"[time] threefry_bits integer bound: {THREEFRY_INT32_OPS} INT32 operations per element x {N_MAIN * F_MAIN} "
          f"elements at {INT32_OPS_PER_CLOCK_PER_SM} per clock per SM x {sms} SMs x {clock_mhz:.0f} MHz (max SM clock) "
          f"= {int_rate:.4e} per s: {int_ms:.4f} ms; kernel {rows['threefry_bits']['ms']:.4f} ms, share "
          f"{int_ms / rows['threefry_bits']['ms']:.3f}", flush=True)

    # the ladder's last rung: tall-skinny qr + matmul on split=0 data (after the kernels' timing, so that
    # they are timed as in earlier runs)
    a_t = torch.randn(N_QR, F_QR, device=dev, generator=gen_new)
    A = ht.array(a_t, split=0, copy=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ht.kernels.reset_kernel_stats()
    t0 = time.perf_counter()
    Q, R = ht.linalg.qr(A)
    torch.cuda.synchronize()
    qr_s = time.perf_counter() - t0
    qr_peak = torch.cuda.max_memory_allocated()
    routes = {k: v for k, v in ht.KERNEL_STATS.items() if k.startswith("qr.")}
    check(sum(routes.values()) == 1 and not any(ht.LAUNCHES.values()), f"qr routes {routes}, launches {dict(ht.LAUNCHES)}")
    qr_route = next(iter(routes))
    check(Q.shape == (N_QR, F_QR) and Q.split == 0 and R.shape == (F_QR, F_QR) and R.split is None
          and Q.larray.dtype == R.larray.dtype == torch.float32 and Q.larray.is_cuda and R.larray.is_cuda, "qr metadata")
    a_max = a_t.abs().max().item()
    r64 = R.larray.double()
    resid, qtq, gram = 0.0, torch.zeros(F_QR, F_QR, dtype=torch.float64, device=dev), torch.zeros_like(r64)
    for r0 in range(0, N_QR, QR_CHUNK):  # float64 checks, a chunk of rows at a time
        qc, ac = Q.larray[r0 : r0 + QR_CHUNK].double(), a_t[r0 : r0 + QR_CHUNK].double()
        resid = max(resid, (qc @ r64 - ac).abs().max().item())
        qtq += qc.T @ qc
        gram += ac.T @ ac
        del qc, ac
    resid /= a_max
    ortho = (qtq - torch.eye(F_QR, dtype=torch.float64, device=dev)).abs().max().item()
    check(resid <= QR_RESID_RTOL, f"||QR - A||max/||A||max = {resid}")
    check(ortho <= QR_ORTHO_ATOL, f"||QᵀQ - I||max = {ortho}")
    del Q
    r_lib = torch.linalg.qr(a_t, mode="r").R

    def sign_normalized(r):
        s_ = torch.sign(torch.diagonal(r))
        return r * torch.where(s_ == 0, torch.ones_like(s_), s_)[:, None]

    r_diff = (sign_normalized(R.larray) - sign_normalized(r_lib)).abs().max().item() / r_lib.abs().max().item()
    check(r_diff <= QR_R_RTOL, f"qr R vs torch.linalg.qr's R: {r_diff}")
    ht.kernels.reset_kernel_stats()
    R_only = ht.linalg.qr(A, calc_q=False).R
    check(ht.KERNEL_STATS.get(qr_route) == 1, f"calc_q=False took another route: {dict(ht.KERNEL_STATS)}")
    r_only_diff = (R_only.larray - R.larray).abs().max().item() / r_lib.abs().max().item()
    check(R_only.split is None and r_only_diff <= QR_R_RTOL, f"qr(calc_q=False) R vs qr R: {r_only_diff}")
    G = ht.matmul(A.T, A)
    g_diff = (G.larray.double() - gram).abs().max().item() / gram.abs().max().item()
    check(G.shape == (F_QR, F_QR) and G.split is None and g_diff <= QR_GRAM_RTOL, f"matmul(A.T, A) vs float64 Gram: {g_diff}")
    print(f"[qr] A {N_QR} x {F_QR} float32 split=0: ht.linalg.qr route {qr_route} ({qr_s:.4f} s first call, peak "
          f"{qr_peak / 2**30:.2f} GiB allocated); Q split {A.split}, R split None; ||QR - A||max/||A||max {resid:.3e}; "
          f"||QᵀQ - I||max {ortho:.3e}; R vs torch.linalg.qr's R (row signs normalized) {r_diff:.3e} of max |R|; "
          f"calc_q=False R vs R {r_only_diff:.3e}; matmul(A.T, A) vs float64 Gram {g_diff:.3e} of max |G|", flush=True)
    del R_only, G, r_lib
    qr_flop = 2 * N_QR * F_QR * F_QR  # bench.py's accounting
    a_bytes = N_QR * F_QR * 4
    qr_times = {
        "ht.linalg.qr": time_ms(lambda: ht.linalg.qr(A), reps=5, warm=1),
        "ht.linalg.qr(calc_q=False)": time_ms(lambda: ht.linalg.qr(A, calc_q=False), reps=5, warm=1),
        "torch.linalg.qr(reduced)": time_ms(lambda: torch.linalg.qr(a_t, mode="reduced"), reps=5, warm=1),
        "torch.linalg.qr(r)": time_ms(lambda: torch.linalg.qr(a_t, mode="r"), reps=5, warm=1),
        "ht.matmul(A.T, A)": time_ms(lambda: ht.matmul(A.T, A), reps=10, warm=2),
        "torch.matmul(A.T, A)": time_ms(lambda: torch.matmul(a_t.T, a_t), reps=10, warm=2),
    }
    for name, ms in qr_times.items():
        flop = qr_flop if "qr" in name else 2 * N_QR * F_QR * F_QR
        print(f"[qr] {name}: {ms:.4f} ms, {flop / ms / 1e6:.1f} GFLOP/s at 2 m n^2 = {flop} flop", flush=True)
    print(f"[qr] bounds at 3.35 TB/s: read A + write Q (2 passes of {a_bytes} B) {2 * a_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"CholeskyQR2 as written, {QR_CHOLQR2_PASSES} passes {QR_CHOLQR2_PASSES * a_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"its 8 m n^2 flop at 67 TFLOP/s (float32 without TF32) {8 * N_QR * F_QR * F_QR / FP32_FLOP_PER_S * 1e3:.4f} ms; "
          f"matmul(A.T, A) reads A once {a_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    del A, a_t, R, r64, qtq, gram
    torch.cuda.empty_cache()
    return kernels


if __name__ == "__main__":
    sys.exit(main())
