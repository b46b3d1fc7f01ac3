"""What the examples share: their flags, the YAML configurations, a box
world and the plot of a plan.  Port of ``examples/_common.py``; it reads the
port's own configurations (:data:`CONFIG_DIR`) and imports matplotlib only
inside :func:`plot_plan` and :func:`figure`."""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.utils.config import CONFIG_DIR, load_params

OUT_DIR = Path(__file__).resolve().parent / "out"
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parser(doc: str) -> argparse.ArgumentParser:
    """The flags every example takes: ``--device`` (the card unless
    ``cpu`` is given; no fallback), ``--dtype`` and ``--plot``."""
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    p.add_argument("--plot", action="store_true",
                   help=f"write the figures to {OUT_DIR}")
    return p


def parse(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv``; ``device`` and ``dtype`` come back as torch
    objects."""
    args = p.parse_args(argv)
    args.device = torch.device(args.device)
    args.dtype = DTYPES[args.dtype]
    return args


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (before reading a wall clock)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_configs(plan_yaml="gpmp2_2d_params.yaml"):
    """(env, planner, gp, obs, optim, robot dicts) of the 2-D YAMLs."""
    return load_params(CONFIG_DIR / plan_yaml, CONFIG_DIR / "robot_2d.yaml",
                       CONFIG_DIR / "env_2d_params.yaml")


def env_params(env_data) -> dict:
    return {"x_lims": env_data["x_lims"], "y_lims": env_data["y_lims"]}


def box_world(device, dtype, imsize=128, x_lims=(-5.0, 5.0)):
    """A box obstacle blocking the main diagonal: (image, SDF (H, W) on
    ``device`` in ``dtype``, resolution)."""
    img = np.ones((imsize, imsize))
    lo, hi = int(0.4 * imsize), int(0.6 * imsize)
    img[lo:hi, lo:hi] = 0.0
    res = (x_lims[1] - x_lims[0]) / imsize
    return img, occupancy_sdf(img, res, device, dtype), res


def occupancy_sdf(img, res, device, dtype) -> torch.Tensor:
    """The SDF of an occupancy image or voxel grid (> 0.75 free)."""
    occ = torch.as_tensor(np.asarray(img), dtype=dtype, device=device)
    build = (sdf_ops.sdf_from_occupancy if occ.ndim == 2
             else sdf_ops.sdf_from_occupancy_3d)
    return build(occ, res=res, dtype=dtype)


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def error_pairs(out, path=""):
    """Every ``(path, err_init, err_final)`` in an example's result: the
    dicts that hold both keys, at any depth."""
    if not isinstance(out, dict):
        return []
    found = []
    if "err_init" in out and "err_final" in out:
        found.append((path or "/", np.atleast_1d(np_(out["err_init"])),
                      np.atleast_1d(np_(out["err_final"]))))
    for k, v in out.items():
        found += error_pairs(v, f"{path}/{k}")
    return found


def unimproved(out, baseline=None) -> list:
    """The plans of an example's result that did not lower a problem's
    error: ``(path, rows, err_init, err_final)`` for each.  ``baseline``
    maps a path to another whose ``err_init`` its plans are held below in
    place of their own (a warm start, whose seed is already near an
    optimum of the old world, against the straight seed's error)."""
    pairs = error_pairs(out)
    init = {path: e0 for path, e0, _ in pairs}
    bad = []
    for path, e0, e1 in pairs:
        e0 = init[(baseline or {}).get(path, path)]
        rows = np.flatnonzero(~(e1 < e0))
        if rows.size:
            bad.append((path, rows, e0[rows], e1[rows]))
    return bad


def figure(*args, **kw):
    """``plt.subplots`` under the Agg backend (imported here only)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt, *plt.subplots(*args, **kw)


def save(plt, fig, name: str) -> Path:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / name
    fig.savefig(path, bbox_inches="tight", dpi=110)
    plt.close(fig)
    print(f"wrote {path}")
    return path


def plot_plan(img, th_init, th_final, name, x_lims=(-5.0, 5.0),
              y_lims=(-5.0, 5.0)) -> Path:
    """The occupancy image with the initial and the optimised path, to
    ``OUT_DIR / name``."""
    plt, fig, ax = figure(figsize=(6, 6))
    ax.imshow(np_(img), cmap="gray", extent=(*x_lims, *y_lims),
              origin="upper")
    ti, tf = np_(th_init), np_(th_final)
    ax.plot(ti[:, 0], ti[:, 1], "r--", label="initial")
    ax.plot(tf[:, 0], tf[:, 1], "b-", label="optimized")
    ax.legend()
    return save(plt, fig, name)
