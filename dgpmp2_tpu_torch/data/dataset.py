"""Planning datasets: the reference's on-disk format and a numpy batch
pipeline.

Port of ``dgpmp2_tpu/data/dataset.py`` (numpy and PyYAML only).  The format
is the JAX package's, byte for byte in the arrays and YAML, so that a
dataset written by either package reads in the other:

    root/{train,test}/meta.yaml                 num_envs, probs_per_env, im_size
    root/{train,test}/im_sdf/{i}_im.png         occupancy image
    root/{train,test}/im_sdf/{i}_sdf.npy        float SDF (metric units)
    root/{train,test}/opt_trajs_<expert>/env_{i}_prob_{j}.npz
                                                keys start/goal/th_opt[/th_init]

The PNG is read and written by :mod:`dgpmp2_tpu_torch.data.png`, not
matplotlib: written as ``imsave(cmap="gray")`` writes it (8-bit RGBA), read
as ``imread`` reads it, then grey by 0.299 R + 0.587 G + 0.114 B and
free space where that exceeds 0.75, as the JAX reader.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import yaml

from dgpmp2_tpu_torch.data import png


def _rgb2gray(im):
    if im.ndim > 2:
        return im[..., :3] @ np.array([0.299, 0.587, 0.114])
    return im


class PlanningDataset:
    """Indexable dataset over one root directory."""

    def __init__(self, root_dir, mode="train", num_envs=-1, num_env_probs=-1,
                 label_subdir="opt_trajs_gpmp2"):
        self.root_dir = os.path.abspath(root_dir)
        self.subdir = os.path.join(self.root_dir, mode)
        self.imsdf_dir = os.path.join(self.subdir, "im_sdf")
        self.label_dir = os.path.join(self.subdir, label_subdir)
        with open(os.path.join(self.subdir, "meta.yaml")) as fp:
            self.meta = yaml.safe_load(fp)
        # Each cap applies on its own (-1 or None: all); asking for more
        # than the dataset holds is an error.
        for key, req in (("num_envs", num_envs),
                         ("probs_per_env", num_env_probs)):
            if req is None or req < 0:
                continue
            if not 0 < req <= self.meta[key]:
                raise ValueError(
                    f"requested {key}={req} but {self.subdir} has "
                    f"{key}={self.meta[key]}"
                )
            self.meta[key] = req
        self._im_cache: Dict[int, np.ndarray] = {}
        self._sdf_cache: Dict[int, np.ndarray] = {}

    def __len__(self):
        return self.meta["num_envs"] * self.meta["probs_per_env"]

    def _load_env(self, env_idx):
        if env_idx not in self._im_cache:
            im = png.read_png(os.path.join(self.imsdf_dir,
                                           f"{env_idx}_im.png"))
            im = np.asarray(_rgb2gray(im) > 0.75, np.float32)
            self._im_cache[env_idx] = im
            self._sdf_cache[env_idx] = np.load(
                os.path.join(self.imsdf_dir, f"{env_idx}_sdf.npy")
            ).astype(np.float32)
        return self._im_cache[env_idx], self._sdf_cache[env_idx]

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        ppe = self.meta["probs_per_env"]
        env_idx, prob_idx = idx // ppe, idx % ppe
        im, sdf = self._load_env(env_idx)
        npf = np.load(
            os.path.join(self.label_dir, f"env_{env_idx}_prob_{prob_idx}.npz")
        )
        return {
            "im": im,
            "sdf": sdf,
            "start": np.asarray(npf["start"], np.float32).reshape(-1),
            "goal": np.asarray(npf["goal"], np.float32).reshape(-1),
            "th_opt": np.asarray(npf["th_opt"], np.float32),
        }


class PlanningDatasetMulti:
    """Several dataset roots, concatenated."""

    def __init__(self, root_dirs: Sequence[str], mode="train", num_envs=-1,
                 num_env_probs=-1, label_subdir="opt_trajs_gpmp2"):
        self.datasets = [
            PlanningDataset(r, mode, num_envs, num_env_probs, label_subdir)
            for r in root_dirs
        ]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


def train_valid_split(n: int, valid_size: float, rng: np.random.Generator,
                      shuffle=True):
    """(train, valid) indices: the first ``floor(valid_size·n)`` of a
    permutation drawn from ``rng`` are the validation split."""
    idxs = np.arange(n)
    if shuffle:
        rng.shuffle(idxs)
    cut = int(np.floor(valid_size * n))
    return idxs[cut:], idxs[:cut]


def as_batches(dataset, indices: Sequence[int], batch_size: int,
               rng: Optional[np.random.Generator] = None,
               drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Stacked numpy batches in index order (a permutation drawn from
    ``rng`` when given); the short last batch is dropped by default."""
    idxs = np.asarray(indices)
    if rng is not None:
        idxs = rng.permutation(idxs)
    n_full = len(idxs) // batch_size
    end = n_full * batch_size if drop_remainder else len(idxs)
    for i in range(0, end, batch_size):
        items = [dataset[int(j)] for j in idxs[i : i + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


# ---------------------------------------------------------------------------
# Writers (used by data generation)
# ---------------------------------------------------------------------------


def save_env(dirpath: str, env_idx: int, im: np.ndarray, sdf: np.ndarray):
    imsdf = os.path.join(dirpath, "im_sdf")
    os.makedirs(imsdf, exist_ok=True)
    png.write_png(os.path.join(imsdf, f"{env_idx}_im.png"), png.gray_rgba(im))
    np.save(os.path.join(imsdf, f"{env_idx}_sdf.npy"), sdf)


def save_problem(dirpath: str, env_idx: int, prob_idx: int, label_subdir: str,
                 start, goal, th_opt, th_init=None):
    lab = os.path.join(dirpath, label_subdir)
    os.makedirs(lab, exist_ok=True)
    out = dict(start=start, goal=goal, th_opt=th_opt)
    if th_init is not None:
        out["th_init"] = th_init
    np.savez(os.path.join(lab, f"env_{env_idx}_prob_{prob_idx}"), **out)


def save_meta(dirpath: str, num_envs: int, probs_per_env: int, im_size: int,
              extra: Optional[dict] = None):
    meta = {"num_envs": num_envs, "probs_per_env": probs_per_env,
            "im_size": im_size}
    if extra:
        meta.update(extra)
    with open(os.path.join(dirpath, "meta.yaml"), "w") as fp:
        yaml.safe_dump(meta, fp)
