"""Ball query (kernels b and c): per set abstraction, the points and the
centroids read once and each scale's indices written once; 9 float32
operations (the squared distance 8, the compare 1) for each of a centroid's
nsample hits at least, a scan may read more. Forward only."""

import re

from pn2bench import yardstick

KERNELS = re.compile(r"\bball_query_(resident|tiled)_kernel\b")


def work(model: dict, B: int, N: int, train: bool) -> tuple[float, float]:
    nbytes = nops = 0.0
    for lv in yardstick.sa_levels(model, N):
        nbytes += 4.0 * B * 3 * (lv["n"] + lv["m"])
        for k, _ in lv["scales"]:
            nbytes += 4.0 * B * lv["m"] * k
            nops += 9.0 * B * lv["m"] * k
    return nbytes, nops
