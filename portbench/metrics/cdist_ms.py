"""``cdist_ms``: host ms of the span around ``ht.spatial.cdist`` up to the card's
finishing the matrix, mean over the jobs."""


def read(run):
    spans = run.spans.get("cdist")
    return sum(spans) / len(spans) * 1e3 if spans else None
