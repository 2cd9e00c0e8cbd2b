"""ENet encoder for 2D multiview features (the JAX package's models/enet.py).

The reference's hand-transcribed Torch7 ENet (encoder only) and its 3-way
split for the 3D pipeline: a frozen prefix (initial block and bottlenecks
0-13), a trainable last section (bottlenecks 14-21) and a 1x1 classifier.
For a 256 x 328 RGB frame the encoder emits 128 channels at 32 x 41, the
per-frame features that data/multiview.py projects onto points.

  initial: concat[Conv3x3/s2 3->13, MaxPool2x2] -> 16 ch, BN, PReLU
  bottleneck 0 (down 16->64, skip padded +48) + 4 regular (proj 16)
  bottleneck 5 (down 64->128, skip padded +64)
  bottlenecks 6-13 and 14-21 (128 ch, proj 32): [regular, dilated 2, asym 5,
      dilated 4, regular, dilated 8, asym 5, dilated 16]
  classifier: 1x1 conv 128 -> num_classes, no bias

Frames come in and features go out channels-last, as in the JAX package:
(B, H, W, 3) -> (B, H/8, W/8, 128), H and W even at every level (an odd size
fails in the JAX module). Inside, the convolutions are stock torch ops on
contiguous NCHW tensors: on an H100 the float32 encoder took 17.5 ms a
batch of 64 frames that way against 20.6 ms on channels-last memory, and
bfloat16 tied (PERF.md). Modules are named after the JAX parameter tree
(encoder.bottleneck_3.core_bn, ...), so enet_state_dict_from_jax maps one
to one. Bit-level behaviour kept from the JAX module:

- padding: flax's 'SAME' on the 2x2 stride-2 down-sampling conv pads
  nothing at even sizes; the asymmetric pair pads (0, 2) then (2, 0); a
  dilated 3x3 pads its dilation;
- bias: proj, core_a, expand and the classifier have none; the initial
  conv, core and core_b have one (flax's default);
- BatchNorm: eps 1e-3, flax's semantics (models/layers._batch_norm over the
  channels-last view: batch statistics with the fast variance, biased
  running variance, momentum 0.9 in flax's convention);
- spatial dropout is not inverted (the reference's Torch7 convention): in
  train mode a (B, C) channel mask drawn from the torch.Generator given to
  forward, with no rescale; in eval mode the output times (1 - p).

model.train() / model.eval() select the mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pointnet2_scannet_tpu_torch.models.layers import _batch_norm

BN_EPS = 1e-3


class PReLU(nn.Module):
    """Per-channel PReLU on NCHW, alpha initialised to 0.25: x where x >= 0,
    else alpha * x (the JAX module's jnp.where)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.view(-1, 1, 1) * x)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d(eps=1e-3) run with flax's semantics on NCHW tensors."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(x.permute(0, 2, 3, 1), self, self.training).permute(0, 3, 1, 2)


class InitialBlock(nn.Module):
    """concat[Conv2d(3->13, 3x3, s2), MaxPool2x2] -> BN -> PReLU (16 ch)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 13, 3, stride=2, padding=1)
        self.bn = BatchNorm(16)
        self.prelu = PReLU(16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.conv(x), F.max_pool2d(x, 2, 2)], dim=1)
        return self.prelu(self.bn(h))


@dataclasses.dataclass(frozen=True)
class BottleneckSpec:
    kind: str  # "regular" | "dilated" | "asym" | "down"
    in_ch: int
    proj_ch: int
    out_ch: int
    dilation: int = 1
    dropout: float = 0.1


class Bottleneck(nn.Module):
    """ENet bottleneck: 1x1 (or 2x2/s2) proj -> core conv -> 1x1 expand, with
    BN and PReLU between, spatial dropout, the residual add, PReLU."""

    def __init__(self, spec: BottleneckSpec):
        super().__init__()
        self.spec = s = spec
        if s.kind == "down":
            self.proj = nn.Conv2d(s.in_ch, s.proj_ch, 2, stride=2, bias=False)
        else:
            self.proj = nn.Conv2d(s.in_ch, s.proj_ch, 1, bias=False)
        self.proj_bn = BatchNorm(s.proj_ch)
        self.proj_prelu = PReLU(s.proj_ch)
        if s.kind == "asym":
            self.core_a = nn.Conv2d(s.proj_ch, s.proj_ch, (1, 5), padding=(0, 2), bias=False)
            self.core_b = nn.Conv2d(s.proj_ch, s.proj_ch, (5, 1), padding=(2, 0))
        else:
            d = s.dilation
            self.core = nn.Conv2d(s.proj_ch, s.proj_ch, 3, padding=d, dilation=d)
        self.core_bn = BatchNorm(s.proj_ch)
        self.core_prelu = PReLU(s.proj_ch)
        self.expand = nn.Conv2d(s.proj_ch, s.out_ch, 1, bias=False)
        self.expand_bn = BatchNorm(s.out_ch)
        self.out_prelu = PReLU(s.out_ch)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        s = self.spec
        h = self.proj_prelu(self.proj_bn(self.proj(x)))
        h = self.core_b(self.core_a(h)) if s.kind == "asym" else self.core(h)
        h = self.core_prelu(self.core_bn(h))
        h = self.expand_bn(self.expand(h))
        if self.training and s.dropout > 0.0:
            if generator is None:
                raise ValueError("train-mode spatial dropout needs a torch.Generator")
            keep = torch.rand(h.shape[:2], generator=generator, device=h.device) >= s.dropout
            h = h * keep.to(h.dtype)[:, :, None, None]
        elif not self.training:
            h = h * (1.0 - s.dropout)
        if s.kind == "down":
            skip = F.pad(F.max_pool2d(x, 2, 2), (0, 0, 0, 0, 0, s.out_ch - s.in_ch))
        else:
            skip = x
        return self.out_prelu(h + skip)


def _section_specs(ch: int, proj: int, dropout: float) -> list[BottleneckSpec]:
    """The repeated 8-block ENet section."""
    pattern = (("regular", 1), ("dilated", 2), ("asym", 1), ("dilated", 4),
               ("regular", 1), ("dilated", 8), ("asym", 1), ("dilated", 16))
    return [BottleneckSpec(kind, ch, proj, ch, dil, dropout) for kind, dil in pattern]


ENET_SPECS: list[BottleneckSpec] = (
    [BottleneckSpec("down", 16, 16, 64, dropout=0.01)]
    + [BottleneckSpec("regular", 64, 16, 64, dropout=0.01)] * 4
    + [BottleneckSpec("down", 64, 32, 128, dropout=0.1)]
    + _section_specs(128, 32, 0.1)
    + _section_specs(128, 32, 0.1)
)
NUM_FIXED_BOTTLENECKS = 14  # with the initial block: frozen in the 3D pipeline
NUM_TRAINABLE_BOTTLENECKS = 8  # the last section


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ENetEncoder(nn.Module):
    """(B, H, W, 3) frames -> (B, H/8, W/8, 128) features."""

    def __init__(self):
        super().__init__()
        self.initial = InitialBlock()
        for i, spec in enumerate(ENET_SPECS):
            self.add_module(f"bottleneck_{i}", Bottleneck(spec))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """generator: the spatial dropout's random stream, on x's device;
        needed in train mode."""
        h = self.initial(_nchw(x))
        for i in range(len(ENET_SPECS)):
            h = getattr(self, f"bottleneck_{i}")(h, generator)
        return _nhwc(h)


class ENetClassifier(nn.Module):
    """1x1 classifier head, channels-last in and out."""

    def __init__(self, num_classes: int = 41):
        super().__init__()
        self.conv = nn.Conv2d(128, num_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.conv(_nchw(x)))


class ENetSemSeg(nn.Module):
    """Encoder and classifier: (B, H, W, 3) -> (B, H/8, W/8, num_classes)."""

    def __init__(self, num_classes: int = 41):
        super().__init__()
        self.encoder = ENetEncoder()
        self.classifier = ENetClassifier(num_classes)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.classifier(self.encoder(x, generator))


# --------------------------- weight import ---------------------------


def _modules_in_order() -> list[tuple[str, str]]:
    """("conv" | "bn" | "prelu", port module prefix) in the order the
    reference's Torch Sequential flattens its state_dict (the JAX
    package's _torch_modules_in_order)."""
    order = [("conv", "encoder.initial.conv"), ("bn", "encoder.initial.bn"),
             ("prelu", "encoder.initial.prelu")]
    for i, spec in enumerate(ENET_SPECS):
        base = f"encoder.bottleneck_{i}"
        order += [("conv", f"{base}.proj"), ("bn", f"{base}.proj_bn"), ("prelu", f"{base}.proj_prelu")]
        if spec.kind == "asym":
            order += [("conv", f"{base}.core_a"), ("conv", f"{base}.core_b")]
        else:
            order.append(("conv", f"{base}.core"))
        order += [("bn", f"{base}.core_bn"), ("prelu", f"{base}.core_prelu"),
                  ("conv", f"{base}.expand"), ("bn", f"{base}.expand_bn"), ("prelu", f"{base}.out_prelu")]
    order.append(("conv", "classifier.conv"))
    return order


def load_torch_enet_weights(path) -> dict[str, np.ndarray]:
    """The reference's Torch checkpoint (data/scannetv2_enet.pth, 41
    classes) -> ENetSemSeg's state_dict (numpy arrays).

    The file's keys are walked in order beside _modules_in_order(): a conv
    takes a weight (OIHW, the port's layout), and a bias only where the next
    key is a 1-D bias under the same prefix as that weight (PReLU weights
    are called 'weight' too); a BatchNorm takes weight, bias, running_mean,
    running_var; a PReLU its weight. Raises ValueError where a key does not
    fit or tensors are left over."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    keys = [k for k in sd if not k.endswith("num_batches_tracked")]
    out: dict[str, np.ndarray] = {}
    ki = 0

    def take(suffix: str) -> np.ndarray:
        nonlocal ki
        if ki >= len(keys) or not keys[ki].endswith(suffix):
            raise ValueError(f"expected a '{suffix}' at key {ki}, found {keys[ki:ki + 1]}")
        ki += 1
        return sd[keys[ki - 1]].numpy()

    for kind, prefix in _modules_in_order():
        if kind == "conv":
            out[f"{prefix}.weight"] = take("weight")
            if (ki < len(keys) and keys[ki].endswith("bias") and ".running_" not in keys[ki]
                    and sd[keys[ki]].ndim == 1
                    and keys[ki].rsplit(".", 1)[0] == keys[ki - 1].rsplit(".", 1)[0]):
                out[f"{prefix}.bias"] = take("bias")
        elif kind == "bn":
            for name in ("weight", "bias", "running_mean", "running_var"):
                out[f"{prefix}.{name}"] = take(name)
            out[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)
        else:
            out[f"{prefix}.weight"] = take("weight")
    if ki != len(keys):
        raise ValueError(f"consumed {ki} of {len(keys)} tensors of {path}")
    return out


def enet_state_dict_from_jax(variables) -> dict[str, np.ndarray]:
    """The JAX ENetSemSeg's {"params", "batch_stats"} tree (numpy or jax
    arrays) -> the port ENetSemSeg's state_dict (numpy arrays): conv
    kernels HWIO -> OIHW, PReLU alpha -> weight, BatchNorm scale / bias /
    mean / var -> weight / bias / running_mean / running_var."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    for kind, prefix in _modules_in_order():
        p = params
        for name in prefix.split("."):
            p = p[name]
        if kind == "conv":
            out[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
            if "bias" in p:
                out[f"{prefix}.bias"] = np.array(p["bias"])
        elif kind == "bn":
            s = stats
            for name in prefix.split("."):
                s = s[name]
            out.update({f"{prefix}.weight": np.array(p["scale"]), f"{prefix}.bias": np.array(p["bias"]),
                        f"{prefix}.running_mean": np.array(s["mean"]),
                        f"{prefix}.running_var": np.array(s["var"]),
                        f"{prefix}.num_batches_tracked": np.array(0, np.int64)})
        else:
            out[f"{prefix}.weight"] = np.array(p["alpha"])
    return out


# ScanNet frame normalisation of the reference's feature extraction
ENET_RGB_MEAN = (0.496342, 0.466664, 0.440796)
ENET_RGB_STD = (0.277856, 0.28623, 0.291129)


def normalize_frame(rgb01: np.ndarray) -> np.ndarray:
    """(H, W, 3) floats in [0, 1] -> normalised for ENet."""
    return (rgb01 - np.asarray(ENET_RGB_MEAN)) / np.asarray(ENET_RGB_STD)


def split_enet_for_3d(model: ENetSemSeg) -> tuple[dict, dict, dict]:
    """The JAX package's split_enet_for_3d on the port's modules: (fixed,
    trainable, classifier), dicts of name -> submodule. fixed holds the
    initial block and bottlenecks 0-13 (freeze them with
    requires_grad_(False) and eval()), trainable bottlenecks 14-21, and
    classifier the 1x1 conv; together they hold every parameter and buffer
    of the model once."""
    enc = dict(model.encoder.named_children())
    cut = {f"bottleneck_{i}" for i in range(NUM_FIXED_BOTTLENECKS,
                                            NUM_FIXED_BOTTLENECKS + NUM_TRAINABLE_BOTTLENECKS)}
    fixed = {k: m for k, m in enc.items() if k not in cut}
    trainable = {k: m for k, m in enc.items() if k in cut}
    return fixed, trainable, dict(model.classifier.named_children())
