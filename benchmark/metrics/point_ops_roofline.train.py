"""Point-op kernels (ops/, ops/cuda/, csrc/): the least time of the
train step's FPS, ball-query, gather, scatter-add and 3-NN work
(roofline/*.py, counted from the shapes) over the device time of the
kernels those files name, in the traced window, in %. Moves train_points_per_s."""

from pn2bench import yardstick


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.kernels:
        return None
    o = run.out
    batches = tr.units  # train steps
    least = 0.0
    for op in run.rooflines:
        nbytes, nops = op.work(run.model, o["batch"], o["npoints"], True)
        t = yardstick.least_seconds(run.device, nbytes, nops)
        if t is None:
            return None
        least += t * batches
    spent = tr.device_s(lambda n: any(op.KERNELS.search(n) for op in run.rooflines))
    return 100.0 * least / spent if spent > 0 else None
