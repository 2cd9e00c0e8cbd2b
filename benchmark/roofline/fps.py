"""Furthest point sampling (kernel a): per set abstraction, 10 float32
operations a source point and step (the squared distance 8, the running
minimum 1, the arg-max compare 1); bytes: the points read once, the indices
written once. Forward only."""

import re

from pn2bench import yardstick

KERNELS = re.compile(r"\bfps(_cluster)?_kernel\b")


def work(model: dict, B: int, N: int, train: bool) -> tuple[float, float]:
    nbytes = nops = 0.0
    for lv in yardstick.sa_levels(model, N):
        nops += 10.0 * B * lv["n"] * lv["m"]
        nbytes += 4.0 * B * (3 * lv["n"] + lv["m"])
    return nbytes, nops
