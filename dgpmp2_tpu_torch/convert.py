"""Carry state across from the JAX package as numpy arrays.

The JAX side hands over ``{f: np.asarray(getattr(p, f)) for f in fields}``
(``None`` kept as ``None``); the port hands back plain numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dgpmp2_tpu_torch.core.gn import PlanResult
from dgpmp2_tpu_torch.core.graph import GraphParams


def graph_params_from_numpy(arrays: dict, device: torch.device | str,
                            dtype: torch.dtype) -> GraphParams:
    """GraphParams on ``device`` from a dict of numpy arrays (or ``None``)."""
    names = {f.name for f in dataclasses.fields(GraphParams)}
    unknown = set(arrays) - names
    if unknown:
        raise ValueError(f"not GraphParams fields: {sorted(unknown)}")
    return GraphParams(**{
        k: None if v is None else torch.tensor(np.asarray(v), dtype=dtype,
                                               device=device)
        for k, v in arrays.items()
    })


def plan_result_to_numpy(result: PlanResult) -> dict:
    """Every field of a PlanResult as a numpy array (``None`` kept)."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in result._asdict().items()}
