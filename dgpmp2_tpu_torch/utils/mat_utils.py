"""Small matrix helpers (port of ``dgpmp2_tpu/utils/mat_utils.py``)."""
from __future__ import annotations

import torch


def isotropic_matrix(sig, dim: int, dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """``sig * I_dim`` on ``device``, the card unless ``device="cpu"``;
    ``sig`` may be a tensor that carries gradients."""
    device = torch.device("cuda" if device is None else device)
    return (torch.as_tensor(sig, dtype=dtype, device=device)
            * torch.eye(dim, dtype=dtype, device=device))
