"""Faults planted in the program, for the tests of the comparison: each is one
way a later change could break the timed path while it still runs."""
from __future__ import annotations

import torch


def apply(name: str) -> None:
    import heat_tpu_torch.classification.kneighborsclassifier as knc
    import heat_tpu_torch.spatial as spatial

    if name == "knn_half_queries":  # half of the queries left out, given the first query's label
        predict = knc.KNeighborsClassifier.predict

        def half(self, x):
            out = predict(self, x)
            t = out.larray
            t[t.shape[0] // 2 :] = t[0]
            return out

        knc.KNeighborsClassifier.predict = half
    elif name == "knn_half_train":  # neighbours searched among half of the training rows
        fit = knc.KNeighborsClassifier.fit

        def half_fit(self, x, y):
            import heat_tpu_torch as ht

            m = x.shape[0] // 2
            return fit(self, ht.array(x.larray[:m], copy=False), ht.array(y.larray[:m], copy=False))

        knc.KNeighborsClassifier.fit = half_fit
    elif name == "knn_answer_altered":  # every 97th label flipped where predict produces it
        predict = knc.KNeighborsClassifier.predict

        def flipped(self, x):
            out = predict(self, x)
            t = out.larray
            t[::97] = torch.where(t[::97] == self.classes_[0].to(t.device), self.classes_[-1].to(t.device),
                                  self.classes_[0].to(t.device))
            return out

        knc.KNeighborsClassifier.predict = flipped
    elif name == "cdist_half_rows":  # the second half of the rows left out, zero
        cdist = spatial.cdist

        def half(*args, **kwargs):
            out = cdist(*args, **kwargs)
            out.larray[out.larray.shape[0] // 2 :] = 0
            return out

        spatial.cdist = half
    elif name == "cdist_answer_altered":  # every 97th column off by a thousandth where cdist produces it
        cdist = spatial.cdist

        def altered(*args, **kwargs):
            out = cdist(*args, **kwargs)
            out.larray[:, ::97] *= 1.001
            return out

        spatial.cdist = altered
    else:
        raise ValueError(f"unknown fault {name!r}")
