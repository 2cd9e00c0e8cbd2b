"""The port's bfloat16 recipe learns as float32 does: the counterpart of
tests/test_bf16_convergence.py.

12 epochs of the chunked Solver over 4 synthetic scenes of 15 000 points,
1024-point chunks, batch 4, SSG at full width (xyz + colour + normal),
float32 then the bfloat16 compute dtype, through
scripts/convergence_bf16_torch.py. Both start from the weights the JAX
test trains: its Solver's initialisation (jax.random.key(0), split, init
on a (1, 1024, 9) sample), moved by models/convert.py. The JAX test's
bars, on the one run: the bfloat16 run must learn on its own terms (the
mean train loss of the last three epochs below 0.9 of the first three's,
the mean val point mIoU up by more than 0.02) and land within 0.05 of
the float32 run's settled val point mIoU. Marked slow (tier-1 runs -m
'not slow'), as the JAX test is:

    python -m pytest tests/test_torch_bf16_convergence.py -m slow
"""

import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_initial_state(npoints: int = 1024, is_msg: bool = False) -> dict:
    """The JAX tests' initial SSG (or, with is_msg, MSG) weights (their
    Solver's init with seed 0) as a port state_dict of float32 tensors."""
    import jax
    import numpy as np

    from pointnet2_scannet_tpu import models
    from pointnet2_scannet_tpu_torch.models import convert, msg_spec, ssg_spec

    init_rng, _ = jax.random.split(jax.random.key(0))
    variables = models.get_model(num_classes=20, is_msg=is_msg, input_channels=6).init(
        init_rng, np.zeros((1, npoints, 9), np.float32), train=False)
    state = convert.state_dict_from_jax(variables, (msg_spec if is_msg else ssg_spec)(20, 6))
    return {k: torch.from_numpy(v) for k, v in state.items()}


@pytest.mark.slow
def test_bf16_training_matches_f32_quality():
    spec = importlib.util.spec_from_file_location("convergence_bf16_torch",
                                                  ROOT / "scripts" / "convergence_bf16_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    row = script.compare(12, "cpu", init=jax_initial_state())
    print(row)
    assert row["bf16_loss_tail"] < row["bf16_loss_head"] * 0.9, row["bf16_losses"]
    assert row["value"] > row["bf16_head"] + 0.02, row["bf16_mious"]
    assert row["value"] > row["f32_tail"] - 0.05, row
