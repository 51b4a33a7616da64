"""setup_s: seconds from the process's start to the first timed call
(generation, encoding, staging, kernel builds and loads, warm-up)."""


def read(run, name):
    return run.setup_s
