"""``device_idle``: share of the traced window in which no kernel, copy or fill
ran on the card, in %."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    window = run.trace.window_s()
    return (1.0 - run.trace.busy_s() / window) * 100.0 if window > 0 else None
