"""device_idle.<op>: the share, in %, of the traced window (first traced
call's start to the last one's end) in which no kernel, copy or memset ran
on the device: one minus the union of their intervals."""


def read(run, name):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
