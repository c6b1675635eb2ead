"""``launches_per_job``: device kernels that started in the window, over the jobs
(from the trace, library kernels included)."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    found = run.trace.kernels()
    return len(found) / run.jobs if found else None
