"""queries_per_s: queries completed in the window over its wall seconds."""


def read(run, name):
    qs = run.of("query")
    return len(qs) / run.window_s if qs else None
