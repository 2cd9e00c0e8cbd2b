"""Model step (models/: BatchNorm, ReLU, the max pools, the reductions):
device ms a train step of the kernels in scripts/profile_torch.py's
elementwise and reduction classes, in the traced window. Moves
train_points_per_s."""

from pn2bench import yardstick


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.kernels:
        return None
    s = tr.device_s(lambda n: yardstick.kernel_class(n) in ("elementwise", "reduction"))
    return 1e3 * s / tr.units
