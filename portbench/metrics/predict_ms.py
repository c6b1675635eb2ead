"""``predict_ms``: host ms of the span around ``KNeighborsClassifier.predict``
and the read of its labels, mean over the jobs."""


def read(run):
    spans = run.spans.get("predict")
    return sum(spans) / len(spans) * 1e3 if spans else None
