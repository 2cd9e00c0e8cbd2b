"""JAX parameters to the port's state_dict (numpy only).

The JAX package's variables are {"params", "batch_stats"} trees, as
engine/checkpoint.restore_params_only returns them. The port names its
modules after that tree, so each scope maps to a dotted prefix:

    params     sa_0/mlp_0/dense_0/kernel (in, out)  -> sa_0.mlp_0.dense_0.weight (out, in)
    params     .../bn_0/{scale, bias}                -> .../bn_0.{weight, bias}
    batch_stats .../bn_0/{mean, var}                 -> .../bn_0.{running_mean, running_var}

and the same for fp_{k}/mlp, cls_fc and cls_out. Values come back as numpy
arrays; load them with model.load_state_dict({k: torch.from_numpy(v)},
strict=True) or engine/checkpoint.save_state_dict.
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from pointnet2_scannet_tpu_torch.models.pointnet2 import PointNet2Spec


def _scopes(spec: PointNet2Spec) -> Iterator[tuple[tuple[str, ...], int]]:
    """(scope, number of layers) of every PointwiseMLP in the model."""
    for k, level in enumerate(spec.sa_mlps):
        for s, widths in enumerate(level):
            yield (f"sa_{k}", f"mlp_{s}"), len(widths)
    for k, widths in enumerate(spec.fp_mlps):
        yield (f"fp_{k}", "mlp"), len(widths)
    yield ("cls_fc",), len(spec.cls_fc)
    yield ("cls_out",), 1


def _node(tree, scope):
    for name in scope:
        tree = tree[name]
    return tree


def state_dict_from_jax(variables, spec: PointNet2Spec) -> dict[str, np.ndarray]:
    """{"params", "batch_stats"} (numpy or jax arrays) -> port state_dict of
    freshly allocated, writable numpy arrays."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    for scope, n_layers in _scopes(spec):
        pnode = _node(params, scope)
        prefix = ".".join(scope)
        for i in range(n_layers):
            dense = pnode[f"dense_{i}"]
            kernel = np.asarray(dense["kernel"], np.float32)
            out[f"{prefix}.dense_{i}.weight"] = np.array(kernel.T, order="C")
            if "bias" in dense:
                out[f"{prefix}.dense_{i}.bias"] = np.array(dense["bias"], np.float32)
            if f"bn_{i}" in pnode:
                bn = pnode[f"bn_{i}"]
                sbn = _node(stats, scope)[f"bn_{i}"]
                base = f"{prefix}.bn_{i}"
                out[f"{base}.weight"] = np.array(bn["scale"], np.float32)
                out[f"{base}.bias"] = np.array(bn["bias"], np.float32)
                out[f"{base}.running_mean"] = np.array(sbn["mean"], np.float32)
                out[f"{base}.running_var"] = np.array(sbn["var"], np.float32)
                out[f"{base}.num_batches_tracked"] = np.array(0, np.int64)
    return out
