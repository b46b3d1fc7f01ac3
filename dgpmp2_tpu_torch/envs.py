"""Occupancy environments: SDF queries, transforms, rendering.

Port of ``dgpmp2_tpu/envs.py``.  ``Env2D`` keeps the reference's
user-facing surface (``diff_gpmp2/env/env_2d.py``): initialisation from a
file or an image, signed-distance queries with their gradients,
world↔pixel transforms with the y-flip, feasibility checks and matplotlib
rendering.  ``Env3D`` carries the same surface over voxel grids.  The
planners never touch these classes: they take raw SDF tensors.

Each environment lives on a ``device`` (the card unless the caller names
the CPU) in a ``dtype``.  Its SDF comes from ``ops.sdf.sdf_from_occupancy``
/ ``sdf_from_occupancy_3d``, and a query goes through ``ops.sdf.lookup`` /
``lookup_nd`` as a batch of one: on the card it launches K-LOOKUP (under
the process's lookup engine) or K-LOOKUP3D, on the CPU it runs their plain
versions.  The transforms compute in float64 on the environment's device
and return tensors.  ``is_feasible`` returns a Python bool, so it waits for
the device.  matplotlib is imported inside the plotting methods only; a
file is read with the port's own PNG reader (``data.png``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


class _Env:
    """The surface both environments share: limits, device, queries."""

    MAX_D: float
    LIMS: tuple = ("x_lims", "y_lims")

    def __init__(self, env_params: dict, device=None,
                 dtype: torch.dtype = torch.float32):
        for name in self.LIMS:
            setattr(self, name, tuple(float(v) for v in env_params[name]))
        self.MAX_D = self.x_lims[1] - self.x_lims[0]
        self.device = _device(device)
        self.dtype = dtype
        self.sedt: Optional[torch.Tensor] = None

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _set_sdf(self, occupancy: np.ndarray, sedt, build):
        if sedt is None:
            self.sedt = build(self._tensor(occupancy, torch.float64),
                              res=self.res, dtype=self.dtype)
        else:
            self.sedt = self._tensor(sedt, self.dtype)

    def _grid(self, pts: torch.Tensor, signs) -> torch.Tensor:
        """World -> fractional grid index per axis: ``-lo/res ± p/res``."""
        lims = [getattr(self, n) for n in self.LIMS]
        cols = [-lo / self.res + s * pts[..., i] / self.res
                for i, ((lo, _), s) in enumerate(zip(lims, signs))]
        return torch.stack(cols, dim=-1)

    def _world(self, idx: torch.Tensor, signs) -> torch.Tensor:
        lims = [getattr(self, n) for n in self.LIMS]
        cols = [s * (idx[..., i] + lo / self.res) * self.res
                for i, ((lo, _), s) in enumerate(zip(lims, signs))]
        return torch.stack(cols, dim=-1)

    def in_limits(self, pt) -> bool:
        return all(lo <= float(pt[i]) <= hi for i, (lo, hi) in enumerate(
            getattr(self, n) for n in self.LIMS))

    def get_signed_obstacle_distance(self, pts):
        """(…, W) world points -> (d (…), ∇d (…, W)); out-of-bounds points
        clamp to MAX_D with zero gradient (intended reference semantics).
        One lookup of all the points, as a batch of one."""
        pts = self._tensor(pts, self.dtype)
        lims = [getattr(self, n) for n in self.LIMS]
        flat = pts.reshape(1, -1, pts.shape[-1]).contiguous()
        d, g = sdf_ops.lookup_nd(self.sedt[None], flat, self.res, *lims)
        return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)

    def is_feasible(self, pt, eps: float = 0.0) -> bool:
        """d(pt) > eps (``env_2d.py:86``); reads the value back to the
        host."""
        d, _ = self.get_signed_obstacle_distance(
            self._tensor(pt, self.dtype)[None])
        return bool(d[0] > eps)


class Env2D(_Env):
    """A 2-D occupancy world: ``image`` (H, W), > 0.75 free, its SDF
    ``sedt`` (H, W) on the environment's device."""

    def __init__(self, env_params: dict, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(env_params, device, dtype)
        self.image: Optional[np.ndarray] = None
        self._plot = None

    # -- initialisation (env_2d.py:33-62) ---------------------------------

    def initialize_from_file(self, envfile: str):
        """An 8-bit PNG (grey, RGB or RGBA; colour to luma as JAX does)."""
        from dgpmp2_tpu_torch.data.png import read_png

        img = read_png(envfile).astype(np.float64)
        if img.ndim > 2:
            img = img[..., :3] @ np.array([0.299, 0.587, 0.114])
        self.initialize_from_image(img)

    def initialize_from_image(self, img, sedt=None):
        self.image = np.asarray(img, np.float64)
        self.res = (self.x_lims[1] - self.x_lims[0]) / self.image.shape[1]
        self._set_sdf(self.image, sedt, sdf_ops.sdf_from_occupancy)

    # -- transforms (env_2d.py:76-99) --------------------------------------

    def to_pixel(self, pts) -> torch.Tensor:
        """(…, 2) world (x, y) -> fractional (col, row), row 0 at the top."""
        return self._grid(self._tensor(pts, torch.float64), (1.0, -1.0))

    def to_world(self, pix) -> torch.Tensor:
        return self._world(self._tensor(pix, torch.float64), (1.0, -1.0))

    # -- rendering (env_2d.py:190-326) --------------------------------------

    def initialize_plot(self, start=None, goal=None, figsize=(6, 6)):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        ax.imshow(self.image, cmap="gray",
                  extent=(*self.x_lims, *self.y_lims), origin="upper")
        if start is not None:
            ax.plot([start[0]], [start[1]], "go", markersize=9, label="start")
        if goal is not None:
            ax.plot([goal[0]], [goal[1]], "r*", markersize=12, label="goal")
        ax.set_xlim(self.x_lims)
        ax.set_ylim(self.y_lims)
        self._plot = (fig, ax)
        return fig, ax

    def plot_edge(self, path, color="blue", linestyle="-", label=None, **kw):
        _, ax = self._plot
        path = np.asarray(path.detach().cpu() if isinstance(
            path, torch.Tensor) else path)
        ax.plot(path[:, 0], path[:, 1], color=color, linestyle=linestyle,
                label=label, **kw)

    def _imshow(self, field: torch.Tensor, **kw):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        m = ax.imshow(field.detach().cpu().numpy(),
                      extent=(*self.x_lims, *self.y_lims), origin="upper",
                      **kw)
        fig.colorbar(m, ax=ax)
        return fig, ax

    def plot_signed_distance_transform(self):
        return self._imshow(self.sedt, cmap="coolwarm")

    def plot_costmap(self, eps: float):
        return self._imshow(sdf_ops.costmap_2d(self.sedt, eps))

    def save_plot(self, path: str):
        self._plot[0].savefig(path, bbox_inches="tight", dpi=120)

    def close_plot(self):
        if self._plot is not None:
            import matplotlib.pyplot as plt

            plt.close(self._plot[0])
            self._plot = None


class Env3D(_Env):
    """A 3-D voxel occupancy world ``voxels`` (D, H, W) indexed ``[z, row,
    col]``: the trailing two axes keep the 2-D image convention (x → col,
    y → row with the y-flip) and z is unflipped with voxel 0 at
    ``z_lims[0]``.  Rendering is by z-slice (:meth:`slice_env2d`)."""

    LIMS = ("x_lims", "y_lims", "z_lims")

    def __init__(self, env_params: dict, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(env_params, device, dtype)
        self.voxels: Optional[np.ndarray] = None

    def initialize_from_voxels(self, vox, sedt=None):
        """``vox``: (D, H, W) occupancy, > 0.75 free (image convention)."""
        self.voxels = np.asarray(vox, np.float64)
        self.res = (self.x_lims[1] - self.x_lims[0]) / self.voxels.shape[-1]
        self._set_sdf(self.voxels, sedt, sdf_ops.sdf_from_occupancy_3d)

    def to_voxel_xyz(self, pts) -> torch.Tensor:
        """(…, 3) world (x, y, z) -> fractional (col, row, depth) indices.

        AXIS-ORDER WARNING: this returns **xyz order** (col, row, depth),
        the order ``ops.sdf.trilinear_lookup`` takes query points in.  The
        dataset generator's ``data.generate3d.world_to_vox_zyx`` returns the
        OPPOSITE **zyx order** (depth, row, col), the ``(D, H, W)``
        indexing ``data.obstacles3d`` carves into.  Both name their order so
        that no caller transposes by accident.
        """
        return self._grid(self._tensor(pts, torch.float64), (1.0, -1.0, 1.0))

    def to_world(self, vox) -> torch.Tensor:
        return self._world(self._tensor(vox, torch.float64), (1.0, -1.0, 1.0))

    def slice_env2d(self, z: float) -> Env2D:
        """The occupancy slice nearest world height ``z`` as an Env2D (the
        2-D plotting surface on that slice).  Its SDF is the z-slice of
        the TRUE 3-D field: distances count obstacles above and below the
        plane, unlike a 2-D EDT of the slice."""
        iz = int(round(-self.z_lims[0] / self.res + z / self.res))
        iz = max(0, min(self.voxels.shape[0] - 1, iz))
        env = Env2D({"x_lims": self.x_lims, "y_lims": self.y_lims},
                    self.device, self.dtype)
        env.initialize_from_image(self.voxels[iz], sedt=self.sedt[iz])
        return env
