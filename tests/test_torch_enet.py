"""The port's ENet (models/enet.py) against the JAX package's on the CPU.

Seeded random weights (conv weights scaled by 1 / sqrt(fan_in), non-trivial
BatchNorm statistics and PReLU slopes) are written as one synthetic .pth in
the reference's key order, walking the JAX package's
_torch_modules_in_order(). Both packages' load_torch_enet_weights read it;
the JAX variables reach the port through enet_state_dict_from_jax too. Eval
logits agree to rtol 1e-3, atol 1e-4, the JAX package's own reference-parity
tolerance (tests/test_multiview.py): the convolutions sum in another order
in XLA and in PyTorch's CPU kernels through 22 residual blocks (measured: at
most 2e-5 absolute, 4e-6 of the largest logit, at 256 x 328). One
Bottleneck in train mode (dropout 0) agrees to the same tolerance in its
output and updated running statistics. The JAX model is
never initialised (its variables come from the .pth), and each shape is
jitted once.
"""

import jax
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.models import enet as jenet
from pointnet2_scannet_tpu_torch.models import enet

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small shapes gain little from more, which
    would only contend with the other workers of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_weights(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in enet.ENetSemSeg(41).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            out[k] = np.array(0, np.int64)
        elif v.dim() == 4:  # conv weight, OIHW
            out[k] = (rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        elif k.endswith(("running_var",)) or (k.endswith("weight") and "bn" in k.rsplit(".", 2)[-2]):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k.endswith("weight"):  # PReLU slopes
            out[k] = rng.uniform(0.1, 0.4, shape).astype(np.float32)
        else:  # conv and BatchNorm biases, running means
            out[k] = rng.normal(0, 0.1, shape).astype(np.float32)
    return out


def _write_reference_pth(path, weights: dict) -> None:
    """The weights in the reference's key order: one numbered module a
    conv, BatchNorm or PReLU, as the JAX loader walks them."""
    sd, names = {}, {"conv": ("weight", "bias"), "prelu": ("weight",),
                     "bn": ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")}
    for n, (kind, jpath) in enumerate(jenet._torch_modules_in_order()):
        prefix = ".".join(jpath)
        for name in names[kind]:
            if f"{prefix}.{name}" in weights:
                sd[f"{n}.{kind}.{name}"] = torch.from_numpy(np.asarray(weights[f"{prefix}.{name}"]))
    torch.save(sd, path)


@pytest.fixture(scope="module")
def weights():
    return _random_weights(0)


@pytest.fixture(scope="module")
def pth(weights, tmp_path_factory):
    path = tmp_path_factory.mktemp("enet") / "enet.pth"
    _write_reference_pth(path, weights)
    return path


@pytest.fixture(scope="module")
def jax_vars(pth):
    return jenet.load_torch_enet_weights(str(pth))


@pytest.fixture(scope="module")
def jax_apply():
    model = jenet.ENetSemSeg(num_classes=41)
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


def _port_model(state: dict) -> enet.ENetSemSeg:
    model = enet.ENetSemSeg(41)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, strict=True)
    return model.eval()


def _frames(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_both_loaders_read_the_reference_pth(weights, pth, jax_vars):
    for got in (enet.load_torch_enet_weights(pth), enet.enet_state_dict_from_jax(jax_vars)):
        assert got.keys() == weights.keys()
        for k, v in weights.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # a file with a tensor left over, or out of order, is refused
    sd = torch.load(pth, weights_only=True)
    torch.save({**sd, "extra.weight": torch.zeros(3)}, pth.parent / "extra.pth")
    with pytest.raises(ValueError, match="consumed"):
        enet.load_torch_enet_weights(pth.parent / "extra.pth")
    keys = list(sd)
    torch.save({k: sd[k] for k in [keys[1], keys[0], *keys[2:]]}, pth.parent / "swapped.pth")
    with pytest.raises(ValueError, match="expected a 'weight'"):
        enet.load_torch_enet_weights(pth.parent / "swapped.pth")


@pytest.mark.parametrize("shape", [(2, 32, 48, 3), (1, 256, 328, 3)], ids=["2x32x48", "1x256x328"])
def test_semseg_logits_match_jax(jax_vars, jax_apply, shape):
    x = _frames(shape, 1)
    want = np.asarray(jax_apply(jax_vars, x))
    with torch.no_grad():
        got = _port_model(enet.enet_state_dict_from_jax(jax_vars))(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], shape[1] // 8, shape[2] // 8, 41)
    assert 0.1 < np.abs(want).max() < 100
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_encoder_features_match_jax(weights, jax_vars):
    x = _frames((2, 32, 48, 3), 2)
    enc_vars = {"params": jax_vars["params"]["encoder"], "batch_stats": jax_vars["batch_stats"]["encoder"]}
    want = np.asarray(jax.jit(lambda v, x: jenet.ENetEncoder().apply(v, x, train=False))(enc_vars, x))
    encoder = _port_model(weights).encoder
    with torch.no_grad():
        got = encoder(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4, 6, 128)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _bottleneck_state(params: dict, stats: dict) -> dict:
    """A JAX Bottleneck's variables -> the port module's state_dict."""
    out = {}
    for name, p in params.items():
        if "kernel" in p:
            out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
            if "bias" in p:
                out[f"{name}.bias"] = np.asarray(p["bias"])
        elif "alpha" in p:
            out[f"{name}.weight"] = np.asarray(p["alpha"])
        else:
            out.update({f"{name}.weight": np.asarray(p["scale"]), f"{name}.bias": np.asarray(p["bias"]),
                        f"{name}.running_mean": np.asarray(stats[name]["mean"]),
                        f"{name}.running_var": np.asarray(stats[name]["var"]),
                        f"{name}.num_batches_tracked": np.array(0, np.int64)})
    return out


@pytest.mark.parametrize("kind,in_ch,out_ch,dil", [("down", 16, 64, 1), ("asym", 32, 32, 1),
                                                   ("dilated", 32, 32, 2)])
def test_bottleneck_train_mode_matches_jax(kind, in_ch, out_ch, dil):
    spec = jenet.BottleneckSpec(kind, in_ch, 8, out_ch, dil, dropout=0.0)
    x = _frames((2, 16, 20, in_ch), 3)
    jm = jenet.Bottleneck(spec)
    variables = jax.jit(lambda x: jm.init(jax.random.key(0), x, train=False))(x)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32),
                                    dict(variables["params"]))
    stats = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                                   dict(variables["batch_stats"]))
    want, updated = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, x)

    pm = enet.Bottleneck(enet.BottleneckSpec(kind, in_ch, 8, out_ch, dil, dropout=0.0))
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in _bottleneck_state(params, stats).items()}, strict=True)
    pm.train()
    got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for name, s in updated["batch_stats"].items():
        bn = getattr(pm, name)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]), rtol=RTOL, atol=ATOL)


def test_spatial_dropout_is_not_inverted():
    """Train mode: each (batch, channel) plane of the branch is either
    dropped or kept unscaled; eval mode: the branch times (1 - p). The out
    PReLU's slope is 1 (the identity), so out = branch * mask + x."""
    torch.manual_seed(0)
    p = 0.5
    m = enet.Bottleneck(enet.BottleneckSpec("regular", 64, 16, 64, dropout=p))
    with torch.no_grad():
        m.out_prelu.weight.fill_(1.0)
    captured = []
    m.expand_bn.register_forward_hook(lambda mod, args, out: captured.append(out))
    x = torch.randn(4, 64, 6, 8)
    with pytest.raises(ValueError, match="Generator"):
        m.train()(x)
    out = m(x, torch.Generator().manual_seed(1))
    h = captured[-1]
    kept = torch.tensor([torch.equal(out[b, c], h[b, c] + x[b, c]) for b in range(4) for c in range(64)])
    dropped = torch.tensor([torch.equal(out[b, c], x[b, c]) for b in range(4) for c in range(64)])
    assert bool((kept | dropped).all()) and 0.3 < float(dropped.float().mean()) < 0.7
    again = m(x, torch.Generator().manual_seed(1))
    assert torch.equal(again, out)
    with torch.no_grad():
        out = m.eval()(x)
    assert torch.equal(out, captured[-1] * (1.0 - p) + x)


def test_split_enet_for_3d_is_an_exact_partition():
    model = enet.ENetSemSeg(41)
    fixed, trainable, classifier = enet.split_enet_for_3d(model)
    assert (len(fixed), len(trainable), len(classifier)) == (
        enet.NUM_FIXED_BOTTLENECKS + 1, enet.NUM_TRAINABLE_BOTTLENECKS, 1)
    assert "initial" in fixed and "bottleneck_13" in fixed and "bottleneck_14" in trainable
    tensors = [t for group in (fixed, trainable, classifier) for mod in group.values()
               for t in [*mod.parameters(), *mod.buffers()]]
    every = [*model.parameters(), *model.buffers()]
    assert len(tensors) == len(every) and {id(t) for t in tensors} == {id(t) for t in every}
