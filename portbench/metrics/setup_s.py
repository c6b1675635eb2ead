"""``setup_s``: seconds from the process's start to the first measured job:
the imports, the libraries (built in a checkout's first run),
the data, the program's set-up and the warm jobs."""


def read(run):
    return run.setup_s
