"""The port's MSG model learns: the counterpart of
tests/test_msg_e2e.py::test_msg_loss_decreases_on_synthetic_scene.

12 epochs of the chunked Solver over 4 synthetic scenes of 15 000 points,
1024-point chunks, batch 4, MSG at full width (xyz + colour + normal): the
mean train loss of the last three epochs must fall below 0.9 of the first
three's, and the mean val point mIoU must rise by more than 0.02. Marked
slow (tier-1 runs -m 'not slow'). The cpu case starts from the JAX test's
initial weights (its Solver's init with seed 0, moved by models/convert.py:
test_torch_bf16_convergence.jax_initial_state) and imports jax inside the
case only; the card's case, marked gpu and skipped without one, starts from
the port's seeded draw, so the file runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_msg_e2e.py -m slow -k cpu
    python -m pytest --noconftest tests/test_torch_msg_e2e.py -m slow -k cuda
"""

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig
from pointnet2_scannet_tpu_torch.data.chunks import ChunkedSceneDataset
from pointnet2_scannet_tpu_torch.data.synthetic import make_synthetic_store
from pointnet2_scannet_tpu_torch.engine.solver import Solver
from pointnet2_scannet_tpu_torch.models import get_model


@pytest.mark.slow
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_msg_loss_decreases_on_synthetic_scene(tmp_path, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    epochs = 12
    cfg = RunConfig(
        tag="msg-e2e-test",
        data=DataConfig(npoints=1024, use_color=True, use_normal=True),
        model=ModelConfig(is_msg=True),
        train=TrainConfig(batch_size=4, epochs=epochs, lr=1e-3, verbose=100, seed=0),
    )
    store = make_synthetic_store(n_scenes=4, n_points=15_000)
    train_ds = ChunkedSceneDataset(store, cfg.data, phase="train", seed=0)
    val_ds = ChunkedSceneDataset(store, cfg.data, phase="val", seed=1)
    model = get_model(cfg.model.num_classes, is_msg=True, input_channels=cfg.data.input_channels,
                      generator=torch.Generator().manual_seed(0))
    if device == "cpu":
        from tests.test_torch_bf16_convergence import jax_initial_state

        model.load_state_dict(jax_initial_state(cfg.data.npoints, is_msg=True), strict=True)
    solver = Solver(model, train_ds, val_ds, cfg, tmp_path, device=device)
    best = solver()

    train_losses = [v for _, v in solver.logger.scalars["train/loss"]]
    mious = [v for _, v in solver.logger.scalars["val/point_miou"]]
    print(f"{device}: train losses {train_losses}; val point mIoU {mious}; best {best}")
    assert np.mean(train_losses[-3:]) < np.mean(train_losses[:3]) * 0.9, train_losses
    assert np.mean(mious[-3:]) > np.mean(mious[:3]) + 0.02, mious
    assert (tmp_path / "model_best.pt").exists()
    assert best["voxel_miou"] >= 0.0
