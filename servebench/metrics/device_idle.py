"""Share of the traced sub-window in which no kernel, copy or fill ran on
the device (``torch.profiler``), in %. Read by every ``device_idle.<x>``
metric."""


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
