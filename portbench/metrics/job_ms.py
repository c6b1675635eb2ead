"""``job_ms``: the window over the jobs completed in it, in ms. The window runs
from the first job's start to the last job's end (host clock)."""


def read(run):
    return run.window_s / run.jobs * 1e3 if run.jobs else None
