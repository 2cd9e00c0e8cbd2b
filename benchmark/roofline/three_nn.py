"""Three nearest neighbours (kernel i): per feature propagation, 9 float32
operations for every pair of an unknown and a known point (the squared
distance 8, the compare 1); bytes: both point sets read once, the three
distances and indices written once. Forward only."""

import re

from pn2bench import yardstick

KERNELS = re.compile(r"\bthree_nn_kernel\b")


def work(model: dict, B: int, N: int, train: bool) -> tuple[float, float]:
    nbytes = nops = 0.0
    for lv in yardstick.fp_levels(model, N):
        nops += 9.0 * B * lv["n"] * lv["m"]
        nbytes += 4.0 * B * (3 * (lv["n"] + lv["m"]) + 6 * lv["n"])
    return nbytes, nops
