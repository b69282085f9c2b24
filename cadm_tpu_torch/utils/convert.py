"""Load parameters of the JAX package into the port.

Both packages keep an MLP layer as ``{"w": (in, out), "b": (out,)}`` and the
member-stacked heads as ``params["fwd"]``/``params["bwd"]`` lists of
``{"w": (n_members, in, out), "b": (n_members, out)}``, so conversion is a
dtype/device copy of every leaf, no transposes. Pass numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``); this module does not import jax.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from cadm_tpu_torch.models.dynamics import NormStats

NORM_FIELDS = ("obs_mean", "obs_std", "act_mean", "act_std", "dobs_mean",
               "dobs_std")


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def params_from_jax(params_np: Mapping, norm_np: Any, device="cpu"
                    ) -> Tuple[dict, NormStats]:
    """(params, NormStats) of the port from the JAX ``params`` dict and
    ``NormStats`` (leaves as numpy arrays)."""
    norm = NormStats(*(
        torch.tensor(np.asarray(getattr(norm_np, f), np.float32), device=device)
        for f in NORM_FIELDS
    ))
    return _to_torch(params_np, device), norm
