"""Row gathers of the forward (kernel d): each set abstraction's centroids;
each scale's grouping, at the narrower of its grouped width (3 + the source
channels) and its first MLP width (what a gather before or after that
layer must move at least); each feature propagation's interpolation, its
result (one row a point). Bytes: indices read once, outputs written once
(a source row that no index names need not be read, so sources are not
counted); no operations."""

import re

from pn2bench import yardstick

KERNELS = re.compile(r"::gather_kernel\b")


def work(model: dict, B: int, N: int, train: bool) -> tuple[float, float]:
    words = 0.0
    for lv in yardstick.sa_levels(model, N):
        m = lv["m"]
        words += B * (m + 3 * m)
        for k, w0 in lv["scales"]:
            g = min(3 + lv["c"], w0)
            words += B * (m * k + m * k * g)
    for lv in yardstick.fp_levels(model, N):
        words += B * (3 * lv["n"] + lv["c"] * lv["n"])
    return 4.0 * words, 0.0
