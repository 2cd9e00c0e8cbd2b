"""Whole train step (engine/train_state.py under parallel/step.py): 3 x the
forward's analytic matmul FLOPs a step (yardstick.fwd_matmul_flops) times
the steps the measured window completed, over its seconds, over the card's
float32 peak outside the tensor cores, in %. Moves train_points_per_s."""

from pn2bench import yardstick


def read(run):
    peak = yardstick.F32_FLOPS.get(run.device)
    if run.kind != "train" or peak is None:
        return None
    o = run.out
    flops = 3.0 * yardstick.fwd_matmul_flops(run.model, o["batch"], o["npoints"]) * o["steps"]
    return 100.0 * flops / o["window_s"] / peak
