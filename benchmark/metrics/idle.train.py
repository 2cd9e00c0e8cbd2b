"""Device: the share of the traced window in which no device operation
ran (the union of their intervals), in %. Moves train_points_per_s."""


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
