"""Scatter-adds of the backward (kernel h and its sort route): the
gradient of every forward gather whose source takes one: each grouping
past the first set abstraction (the input's features take none), at the
narrower of the source channels and the first MLP width, and each
interpolation, its gradient read one row a point. Bytes: cotangents and
indices read once, the source-shaped sum written once; one float32 add a
cotangent word. Train only."""

import re

from pn2bench import yardstick

KERNELS = re.compile(r"::(block|tile_count|tile_prefix|row_scan|place|segment_sum)_kernel\b")


def work(model: dict, B: int, N: int, train: bool) -> tuple[float, float]:
    if not train:
        return 0.0, 0.0
    words = nops = 0.0
    for lv in yardstick.sa_levels(model, N)[1:]:
        n, m = lv["n"], lv["m"]
        for k, w0 in lv["scales"]:
            g = min(lv["c"], w0)
            words += B * (m * k + m * k * g + n * g)
            nops += B * m * k * g
    for lv in yardstick.fp_levels(model, N):
        words += B * (lv["c"] * lv["n"] + 3 * lv["n"] + lv["c"] * lv["m"])
        nops += 3.0 * B * lv["n"] * lv["c"]
    return 4.0 * words, nops
