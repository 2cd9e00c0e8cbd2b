"""JAX parameters, and the reference's checkpoints, to the port's
state_dict and back (numpy only; torch for the files).

The JAX package's variables are {"params", "batch_stats"} trees, as
engine/checkpoint.restore_params_only returns them. The port names its
modules after that tree, so each scope maps to a dotted prefix:

    params     sa_0/mlp_0/dense_0/kernel (in, out)  -> sa_0.mlp_0.dense_0.weight (out, in)
    params     .../bn_0/{scale, bias}                -> .../bn_0.{weight, bias}
    batch_stats .../bn_0/{mean, var}                 -> .../bn_0.{running_mean, running_var}

and the same for fp_{k}/mlp, cls_fc and cls_out; of the shape families'
trees (models/pointnet2_cls.py, pointnet2_partseg.py), sa{k}/mlp_{s},
fp{k}/mlp, head_fc and head_out the same way, and a classifier's FC blocks

    params     fc1/fc/{kernel, bias}                 -> fc1.fc.{weight, bias}
    params     fc1/bn/{scale, bias}                   -> fc1.bn.{weight, bias}
    batch_stats fc1/bn/{mean, var}                    -> fc1.bn.{running_mean, running_var}

(bn_pre likewise, and head); module_state_dict_from_jax maps a single
module's tree (the votenet modules) the same way. Values come back as numpy
arrays; load them with model.load_state_dict({k: torch.from_numpy(v)},
strict=True) or engine/checkpoint.save_state_dict.

The reference (Pointnet2.ScanNet) saves bare model.state_dict() files
(model.pth) named after its SharedMLP / Conv wrappers:

    SA_modules.{k}.mlps.{s}.layer{i}.conv.weight (out, in, 1, 1) <-> sa_{k}.mlp_{s}.dense_{i}.weight (out, in)
    SA_modules.{k}.mlps.{s}.layer{i}.bn.bn.{weight, bias, running_mean, running_var, num_batches_tracked}
                                                             <-> sa_{k}.mlp_{s}.bn_{i}.*
    FP_modules.{k}.mlp.layer{i}.*                            <-> fp_{k}.mlp.*_{i}
    cls_layer.0.conv.weight (out, in, 1), cls_layer.0.bn.bn.* <-> cls_fc.dense_0, cls_fc.bn_0
    cls_layer.2.*  (after the Dropout at cls_layer.1)          <-> cls_out.dense_0, cls_out.bn_0

(a conv has a bias only where no BatchNorm follows). convert_torch_pointnet2
and export_torch_pointnet2 map between the two directly, as the JAX
package's functions of those names map the reference's keys to and from
its flax tree; num_batches_tracked comes in as 0, as the JAX route's
state_dict_from_jax gives it, and goes out as 0.
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from pointnet2_scannet_tpu_torch.models.pointnet2 import PointNet2Spec


def _scopes(spec) -> Iterator[tuple[tuple[str, ...], int]]:
    """(scope, number of layers) of every PointwiseMLP in the model: of a
    segmentation model (PointNet2Spec), a shape classifier (PointNet2ClsSpec,
    whose head is FC blocks, _fc_scopes) or a part segmenter
    (PointNet2PartSegSpec), told apart by their fields."""
    if hasattr(spec, "sa_levels"):  # the shape families
        for k, (_, _, _, mlps) in enumerate(spec.sa_levels):
            for s, widths in enumerate(mlps):
                yield (f"sa{k + 1}", f"mlp_{s}"), len(widths)
        if hasattr(spec, "fp_mlps"):  # part segmentation: fp{n}..fp1, then the head
            for j, widths in enumerate(spec.fp_mlps):
                yield (f"fp{len(spec.sa_levels) - j}", "mlp"), len(widths)
            yield ("head_fc",), 1
            yield ("head_out",), 1
        return
    for k, level in enumerate(spec.sa_mlps):
        for s, widths in enumerate(level):
            yield (f"sa_{k}", f"mlp_{s}"), len(widths)
    for k, widths in enumerate(spec.fp_mlps):
        yield (f"fp_{k}", "mlp"), len(widths)
    yield ("cls_fc",), len(spec.cls_fc)
    yield ("cls_out",), 1


def _fc_scopes(spec) -> list[str]:
    """The FC blocks of a shape classifier's head (fc1.., head): a Dense fc
    and a BatchNorm bn (bn_pre when pre-activated), or none."""
    if not hasattr(spec, "fc_widths"):
        return []
    return [f"fc{j + 1}" for j in range(len(spec.fc_widths))] + ["head"]


def _node(tree, scope):
    for name in scope:
        tree = tree[name]
    return tree


def _ref_blocks(spec: PointNet2Spec) -> Iterator[tuple[str, str, int]]:
    """(reference key of the layer, port prefix of the layer, conv rank) of
    every Linear(+BN) layer that the reference's model.pth holds."""
    for k, level in enumerate(spec.sa_mlps):
        for s, widths in enumerate(level):
            for i in range(len(widths)):
                yield f"SA_modules.{k}.mlps.{s}.layer{i}", f"sa_{k}.mlp_{s}.{{}}_{i}", 4
    for k, widths in enumerate(spec.fp_mlps):
        for i in range(len(widths)):
            yield f"FP_modules.{k}.mlp.layer{i}", f"fp_{k}.mlp.{{}}_{i}", 4
    # the reference's head: Conv1d, Dropout, Conv1d
    yield "cls_layer.0", "cls_fc.{}_0", 3
    yield "cls_layer.2", "cls_out.{}_0", 3


_BN_KEYS = ("weight", "bias", "running_mean", "running_var")  # bn.bn.* and bn_{i}.*


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def convert_torch_pointnet2(state_dict, spec: PointNet2Spec) -> dict[str, np.ndarray]:
    """A reference model.pth state_dict (tensors or numpy arrays) -> the
    port's state_dict (float32 numpy arrays). Raises ValueError where a
    reference tensor is left over, KeyError where one is missing."""
    sd = {k: _numpy(v) for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    out: dict[str, np.ndarray] = {}
    for ref, port, _ in _ref_blocks(spec):
        w = sd.pop(f"{ref}.conv.weight")
        out[port.format("dense") + ".weight"] = np.array(w.reshape(w.shape[0], w.shape[1]), np.float32)
        if f"{ref}.conv.bias" in sd:
            out[port.format("dense") + ".bias"] = np.array(sd.pop(f"{ref}.conv.bias"), np.float32)
        if f"{ref}.bn.bn.weight" in sd:
            for key in _BN_KEYS:
                out[f"{port.format('bn')}.{key}"] = np.array(sd.pop(f"{ref}.bn.bn.{key}"), np.float32)
            out[f"{port.format('bn')}.num_batches_tracked"] = np.array(0, np.int64)
    if sd:
        raise ValueError(f"unconsumed reference tensors: {sorted(sd)[:8]} ...")
    return out


def load_torch_pointnet2(path, spec: PointNet2Spec) -> dict[str, np.ndarray]:
    """convert_torch_pointnet2 of a reference model.pth file."""
    import torch

    return convert_torch_pointnet2(torch.load(path, map_location="cpu", weights_only=True), spec)


def export_torch_pointnet2(state_dict, spec: PointNet2Spec) -> dict[str, np.ndarray]:
    """The inverse of convert_torch_pointnet2: the port's state_dict
    (tensors or numpy arrays) -> a reference-format state_dict (numpy
    arrays, the reference's key names and shapes), which the reference's
    model loads with load_state_dict(strict=True). The reference's head is
    exactly Conv1d, Dropout, Conv1d, so a multi-layer cls_fc raises."""
    if len(spec.cls_fc) != 1:
        raise ValueError(f"reference export supports a single-layer cls_fc, got {spec.cls_fc}")
    sd = {k: _numpy(v) for k, v in state_dict.items()}
    out: dict[str, np.ndarray] = {}
    for ref, port, rank in _ref_blocks(spec):
        w = np.asarray(sd[port.format("dense") + ".weight"], np.float32)
        out[f"{ref}.conv.weight"] = w.reshape(w.shape + (1,) * (rank - 2))
        if port.format("dense") + ".bias" in sd:
            out[f"{ref}.conv.bias"] = np.asarray(sd[port.format("dense") + ".bias"], np.float32)
        if f"{port.format('bn')}.weight" in sd:
            for key in _BN_KEYS:
                out[f"{ref}.bn.bn.{key}"] = np.asarray(sd[f"{port.format('bn')}.{key}"], np.float32)
            out[f"{ref}.bn.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def save_torch_pointnet2(path, state_dict, spec: PointNet2Spec) -> None:
    """Write export_torch_pointnet2's state_dict as a reference-loadable
    model.pth."""
    import torch

    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in export_torch_pointnet2(state_dict, spec).items()}, path)


def state_dict_from_jax(variables, spec) -> dict[str, np.ndarray]:
    """{"params", "batch_stats"} (numpy or jax arrays) of a segmentation
    model, a shape classifier or a part segmenter (spec: PointNet2Spec,
    PointNet2ClsSpec or PointNet2PartSegSpec) -> port state_dict of freshly
    allocated, writable numpy arrays. A classifier's FC block fc{j} maps
    fc1/fc/kernel -> fc1.fc.weight and fc1/bn (or bn_pre) -> fc1.bn (bn_pre)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    for scope, n_layers in _scopes(spec):
        pnode = _node(params, scope)
        prefix = ".".join(scope)
        for i in range(n_layers):
            _dense_into(out, f"{prefix}.dense_{i}", pnode[f"dense_{i}"])
            if f"bn_{i}" in pnode:
                _bn_into(out, f"{prefix}.bn_{i}", pnode[f"bn_{i}"], _node(stats, scope)[f"bn_{i}"])
    for scope in _fc_scopes(spec):
        pnode = params[scope]
        _dense_into(out, f"{scope}.fc", pnode["fc"])
        for bn in ("bn_pre", "bn"):
            if bn in pnode:
                _bn_into(out, f"{scope}.{bn}", pnode[bn], stats[scope][bn])
    return out


def module_state_dict_from_jax(variables) -> dict[str, np.ndarray]:
    """{"params", "batch_stats"} of a JAX module built of PointwiseMLPs or
    FC blocks (the votenet modules: mlp, mlp_{s} and post_mlp, each of
    dense_i and bn_i) -> the port module's state_dict, every Dense (a scope
    with a kernel) and BatchNorm (a scope with a scale) at its dotted path:

        params      mlp_0/dense_1/kernel (in, out) -> mlp_0.dense_1.weight (out, in)
        params      post_mlp/bn_0/{scale, bias}    -> post_mlp.bn_0.{weight, bias}
        batch_stats post_mlp/bn_0/{mean, var}      -> post_mlp.bn_0.{running_mean, running_var}
    """
    out: dict[str, np.ndarray] = {}

    def walk(pnode, snode, prefix: str) -> None:
        for name, child in pnode.items():
            if "kernel" in child:
                _dense_into(out, prefix + name, child)
            elif "scale" in child:
                _bn_into(out, prefix + name, child, snode[name])
            else:
                walk(child, snode.get(name, {}), f"{prefix}{name}.")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return out


def _dense_into(out: dict, name: str, dense) -> None:
    out[f"{name}.weight"] = np.array(np.asarray(dense["kernel"], np.float32).T, order="C")
    if "bias" in dense:
        out[f"{name}.bias"] = np.array(dense["bias"], np.float32)


def _bn_into(out: dict, name: str, bn, sbn) -> None:
    out[f"{name}.weight"] = np.array(bn["scale"], np.float32)
    out[f"{name}.bias"] = np.array(bn["bias"], np.float32)
    out[f"{name}.running_mean"] = np.array(sbn["mean"], np.float32)
    out[f"{name}.running_var"] = np.array(sbn["var"], np.float32)
    out[f"{name}.num_batches_tracked"] = np.array(0, np.int64)
