"""Plain PyTorch reference of PointNet++ semantic segmentation (SSG and MSG)
and of its training step, for the benchmark's check of `correct`.

It follows the published description (Qi et al., arXiv:1706.02413) and the
reference implementation the port was modelled on (ero1311/Pointnet2.ScanNet,
pointnet2/pointnet2_semseg.py and its CUDA point ops):

- furthest point sampling from index 0, squared distances
  ((dx*dx + dy*dy) + dz*dz), the first of equal maxima taken; points with
  |p|^2 <= 1e-3 are never picked (the reference CUDA op skips them);
- ball query: the first nsample indices in ascending order with
  d^2 < r^2 (r^2 in float32), the row padded with its first hit, zeros for
  an empty ball;
- grouping [xyz - centroid | features], a pointwise MLP (Linear without
  bias, BatchNorm, ReLU), max over the neighbours, the scales concatenated;
  where the grouped input is at least twice as wide as the first layer
  (MSG's third and fourth levels) that Linear runs before the gather, which
  it commutes with: the same function in the cheaper order;
- feature propagation: the three nearest known points (first of equal
  distances), weights 1 / (sqrt(d^2) + 1e-8) normalised, concatenated with
  the skip features, a pointwise MLP;
- the head: Linear, BatchNorm, ReLU, Dropout (keep 1 - p, kept values scaled
  by 1 / (1 - p), the mask drawn with torch.rand from the caller's
  generator), Linear, BatchNorm;
- BatchNorm in flax's convention (the JAX package's train step): batch
  statistics over every axis but the last with the variance
  max(E[x^2] - E[x]^2, 0), running statistics m * old + (1 - m) * batch with
  m = 0.9, eps 1e-5; eval mode uses the running statistics;
- the loss: the class-weighted softmax cross-entropy averaged over every
  point of the real rows;
- Adam (0.9, 0.999, 1e-8) with coupled L2 weight decay.

Parameters are a flat dict of tensors keyed by the published tree's names
(sa_{level}.mlp_{scale}.dense_{i}.weight, bn_{i}.weight / bias /
running_mean / running_var; fp_{level}.mlp...; cls_fc...; cls_out...).
This file imports torch alone. Work that grows with the batch runs in blocks
of rows, so the reference fits beside nothing else on the card.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
BLOCK_ELEMS = 1 << 28  # distance-matrix elements a block of rows may hold


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products in full float32 (tf32 False) or in TF32 (the
    control's lower precision)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rows(total: int, per_row: int) -> int:
    return max(1, min(total, BLOCK_ELEMS // max(per_row, 1)))


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) x (B, N, 3) -> (B, M, N), each operation rounded alone."""
    d = None
    for k in range(3):
        diff = a[:, :, None, k] - b[:, None, :, k]
        d = diff * diff if d is None else d + diff * diff
    return d


@torch.no_grad()
def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64."""
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    valid = (x * x + y * y) + z * z > 1e-3
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    neg = torch.tensor(-1.0, dtype=xyz.dtype, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, last]
        dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(torch.where(valid, mind, neg), dim=1)
        out[:, j] = last
    return out


@torch.no_grad()
def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points, (B, M, 3) centres -> (B, M, nsample) int64."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    iota = torch.arange(N, device=xyz.device)
    out = []
    step = _rows(B, M * N)
    for s in range(0, B, step):
        d2 = _sqdist(new_xyz[s:s + step], xyz[s:s + step])
        masked = torch.where(d2 < r2.to(d2.dtype), iota, N)
        idx = torch.topk(masked, min(nsample, N), dim=-1, largest=False, sorted=True).values
        first = idx[..., :1]
        out.append(torch.where(idx < N, idx, torch.where(first < N, first, torch.zeros_like(first))))
    return torch.cat(out)


@torch.no_grad()
def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3) x (B, m, 3) -> (squared distances (B, n, 3), idx (B, n, 3)
    int64), nearest first, the lowest index of equal distances first."""
    B, n, _ = unknown.shape
    m = known.shape[1]
    iota = torch.arange(m, device=known.device)
    dists, idxs = [], []
    step = _rows(B, n * m)
    for s in range(0, B, step):
        d = _sqdist(unknown[s:s + step], known[s:s + step])
        ds, js = [], []
        for k in range(3):
            dmin = d.amin(dim=-1, keepdim=True)
            sel = torch.where(d == dmin, iota, m).amin(dim=-1, keepdim=True)
            ds.append(dmin)
            js.append(sel)
            if k < 2:
                d = torch.where(iota == sel, torch.inf, d)
        dists.append(torch.cat(ds, -1))
        idxs.append(torch.cat(js, -1))
    return torch.cat(dists), torch.cat(idxs)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows at idx (B, ...) -> (B, ..., C)."""
    B, _, C = x.shape
    flat = idx.reshape(B, -1)
    return torch.gather(x, 1, flat[..., None].expand(-1, -1, C)).reshape(*idx.shape, C)


def batch_norm(x: torch.Tensor, p: dict, name: str, train: bool) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if not train:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    else:
        dims = tuple(range(x.dim() - 1))
        mean, mean2 = x.mean(dims), (x * x).mean(dims)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            for key, v in (("running_mean", mean), ("running_var", var)):
                p[f"{name}.{key}"].copy_(BN_MOMENTUM * p[f"{name}.{key}"] + (1.0 - BN_MOMENTUM) * v)
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * w) + b


def mlp(x: torch.Tensor, p: dict, name: str, layers: int, train: bool, last_relu: bool = True,
        first: int = 0) -> torch.Tensor:
    for i in range(first, layers):
        x = batch_norm(F.linear(x, p[f"{name}.dense_{i}.weight"]), p, f"{name}.bn_{i}", train)
        if last_relu or i < layers - 1:
            x = torch.relu(x)
    return x


def forward(cfg: dict, p: dict, points: torch.Tensor, *, train: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, N, 3 + C) -> logits (B, N, classes). cfg: the configuration's
    "model" entry. In train mode BatchNorm moves p's running statistics in
    place and Dropout draws from generator."""
    xyz = points[..., :3].contiguous()
    feats = points[..., 3:].contiguous()
    l_xyz, l_feats = [xyz], [feats]
    for lvl, npoint in enumerate(cfg["npoints"]):
        src, f = l_xyz[-1], l_feats[-1]
        new_xyz = _gather(src, furthest_point_sample(src, npoint))
        outs = []
        for s, (radius, k) in enumerate(zip(cfg["radii"][lvl], cfg["nsamples"][lvl])):
            nidx = ball_query(radius, k, src, new_xyz)
            name, widths = f"sa_{lvl}.mlp_{s}", cfg["sa_mlps"][lvl][s]
            rel = _gather(src, nidx) - new_xyz[:, :, None, :]
            if 3 + f.shape[-1] >= 2 * widths[0]:
                # wide input: the first Linear before the gather (it commutes
                # with a row gather), the cheaper order of the same function
                w = p[f"{name}.dense_0.weight"]
                h = _gather(f @ w[:, 3:].t(), nidx) + rel @ w[:, :3].t()
                h = torch.relu(batch_norm(h, p, f"{name}.bn_0", train))
                h = mlp(h, p, name, len(widths), train, first=1)
            else:
                h = mlp(torch.cat([rel, _gather(f, nidx)], dim=-1), p, name, len(widths), train)
            outs.append(h.amax(dim=2))
        l_xyz.append(new_xyz)
        l_feats.append(torch.cat(outs, dim=-1))
    for lvl in reversed(range(len(cfg["fp_mlps"]))):
        d2, idx = three_nn(l_xyz[lvl], l_xyz[lvl + 1])
        recip = 1.0 / (torch.sqrt(d2) + 1e-8)
        w = recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])
        known = _gather(l_feats[lvl + 1], idx)  # (B, n, 3, C)
        interp = (known * w[..., None]).sum(dim=2)
        h = torch.cat([interp, l_feats[lvl]], dim=-1)
        l_feats[lvl] = mlp(h, p, f"fp_{lvl}.mlp", len(cfg["fp_mlps"][lvl]), train)
    h = mlp(l_feats[0], p, "cls_fc", len(cfg["cls_fc"]), train)
    if train and cfg["dropout"] > 0:
        keep_prob = 1.0 - cfg["dropout"]
        keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
        h = torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype, device=h.device))
    return mlp(h, p, "cls_out", 1, train, last_relu=False)


def weighted_cross_entropy(logits, labels, weights, row_mask) -> torch.Tensor:
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    label_logit = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    ce = torch.log(torch.exp(shifted).sum(dim=-1)) - label_logit
    return (ce * weights * row_mask[:, None]).sum() / (torch.clamp(row_mask.sum(), min=1.0) * ce.shape[-1])


class Trainer:
    """The reference train state: parameters and BatchNorm statistics (a
    dict), Adam's moments, the step count, the Dropout generator."""

    def __init__(self, cfg: dict, params: dict, *, lr_at, weight_decay: float, generator: torch.Generator,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.cfg = cfg
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.trainable = [k for k in self.p if k.endswith(".weight") or k.endswith(".bias")]
        self.m = {k: torch.zeros_like(self.p[k]) for k in self.trainable}
        self.v = {k: torch.zeros_like(self.p[k]) for k in self.trainable}
        self.lr_at, self.wd, self.betas, self.eps = lr_at, weight_decay, betas, eps
        self.generator = generator
        self.step_count = 0

    def step(self, batch: dict) -> float:
        """One optimizer step on a batch of "points", "labels", "weights",
        "row_mask"; returns its loss."""
        for k in self.trainable:
            self.p[k].requires_grad_(True)
        logits = forward(self.cfg, self.p, batch["points"], train=True, generator=self.generator)
        loss = weighted_cross_entropy(logits, batch["labels"], batch["weights"], batch["row_mask"])
        grads = torch.autograd.grad(loss, [self.p[k] for k in self.trainable])
        lr = self.lr_at(self.step_count)
        self.step_count += 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** self.step_count, 1.0 - b2 ** self.step_count
        with torch.no_grad():
            for k, g in zip(self.trainable, grads):
                p = self.p[k].detach()
                g = g + self.wd * p
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
                self.p[k] = p - (lr / bc1) * self.m[k] / denom
        return float(loss.detach())

