"""Deterministic generator for the bundled datasets.

The reference ships small real datasets (``heat/datasets/iris.csv``,
``diabetes.h5``) and validates its estimators against known outcomes on
them (``heat/cluster/tests/test_kmeans.py:77-107``). This build commits
*generated* datasets instead, each with its exact ground truth stored in
the file — so estimator tests assert against recorded truth rather than
magic constants, and the data provably contains no copied bytes.

Run ``python -m heat_tpu_torch.datasets.generate`` from the repo root to
regenerate; the files are committed, tests only read them.

Files (all small, KB-scale):
- ``blobs.h5`` / ``blobs.csv``: 4 well-separated 2-D gaussian clusters,
  600 rows. h5 datasets: ``data`` (600, 2), ``labels`` (600,),
  ``centers`` (4, 2) — the exact generating means.
- ``classes.h5``: 3-class gaussian classification set, 6 features,
  450 train + 150 test rows (``train_x/train_y/test_x/test_y``), feature
  variances differ per class (exercises GaussianNB's per-class moments).
- ``regression.h5``: sparse linear regression, 400 x 12, ``x``, ``y``,
  ``coef`` (the true weights: 4 non-zeros), noise sigma 0.05.
"""
from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def make_blobs_file(path: str) -> None:
    import h5py

    rng = np.random.default_rng(20260730)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [0.0, 8.0], [8.0, 0.0]], np.float32)
    per = 150
    data, labels = [], []
    for i, c in enumerate(centers):
        data.append(c + rng.normal(0, 0.6, size=(per, 2)).astype(np.float32))
        labels.append(np.full(per, i, np.int64))
    data = np.concatenate(data)
    labels = np.concatenate(labels)
    order = rng.permutation(len(data))
    data, labels = data[order], labels[order]
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data)
        f.create_dataset("labels", data=labels)
        f.create_dataset("centers", data=centers)
    np.savetxt(
        os.path.splitext(path)[0] + ".csv", data, delimiter=";", fmt="%.4f"
    )


def make_classes_file(path: str) -> None:
    import h5py

    rng = np.random.default_rng(20260731)
    f_dim, n_train, n_test = 6, 450, 150
    means = rng.normal(0, 4.0, size=(3, f_dim)).astype(np.float32)
    sigmas = np.array([0.6, 1.0, 1.5], np.float32)  # per-class spread

    def draw(n_per):
        xs, ys = [], []
        for cls in range(3):
            xs.append(
                means[cls] + sigmas[cls] * rng.normal(size=(n_per, f_dim)).astype(np.float32)
            )
            ys.append(np.full(n_per, cls, np.int64))
        order = rng.permutation(3 * n_per)
        return np.concatenate(xs)[order], np.concatenate(ys)[order]

    train_x, train_y = draw(n_train // 3)
    test_x, test_y = draw(n_test // 3)
    with h5py.File(path, "w") as f:
        f.create_dataset("train_x", data=train_x)
        f.create_dataset("train_y", data=train_y)
        f.create_dataset("test_x", data=test_x)
        f.create_dataset("test_y", data=test_y)
        f.create_dataset("means", data=means)


def make_regression_file(path: str) -> None:
    import h5py

    rng = np.random.default_rng(20260801)
    n, f_dim = 400, 12
    coef = np.zeros(f_dim, np.float32)
    coef[[1, 4, 7, 10]] = np.array([3.0, -2.0, 1.5, -4.0], np.float32)
    x = rng.normal(size=(n, f_dim)).astype(np.float32)
    y = x @ coef + 0.05 * rng.normal(size=n).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=x)
        f.create_dataset("y", data=y.astype(np.float32))
        f.create_dataset("coef", data=coef)


def main() -> None:
    make_blobs_file(os.path.join(HERE, "blobs.h5"))
    make_classes_file(os.path.join(HERE, "classes.h5"))
    make_regression_file(os.path.join(HERE, "regression.h5"))
    print("datasets regenerated in", HERE)


if __name__ == "__main__":
    main()
