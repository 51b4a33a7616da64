"""load_GBps: plain bytes (1e9 a GB) of every column decoded into device
memory by the window's loads, over the window's wall seconds (first call's
start to the last call's synchronize)."""


def read(run, name):
    loads = run.of("load")
    if not loads:
        return None
    return sum(c["plain_bytes"] for c in loads) / 1e9 / run.window_s
