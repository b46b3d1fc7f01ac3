"""Angle normalisation (port of ``dgpmp2_tpu/utils/angles.py``), on
tensors or Python numbers."""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def normalize_angle_positive(angle):
    """Normalise (radians) to [0, 2π)."""
    return (angle % TWO_PI + TWO_PI) % TWO_PI


def normalize_angle(angle):
    """Normalise (radians) to (-π, π]."""
    ang = torch.as_tensor(normalize_angle_positive(angle))
    return torch.where(ang > math.pi, ang - TWO_PI, ang)


def angular_distance(ang1, ang2):
    """Signed angular distance ``ang2 - ang1`` normalised to (-π, π]."""
    return normalize_angle(ang2 - ang1)
