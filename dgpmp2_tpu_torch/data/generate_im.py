"""Image/SDF-only dataset generation.

Port of ``dgpmp2_tpu/data/generate_im.py`` (the reference's
``datasets/generate_2d_im_dataset.py:11-66``): datasets of ``(im, sdf)``
pairs with no planning problems, from simple primitives (one fixed-size
obstacle, one variable-size obstacle, several obstacles) or from a folder of
images; used to pretrain or probe the conv encoder and the initializer
network.  The SDF is the repo's native host EDT
(:func:`dgpmp2_tpu_torch.native.sdf_2d`); PNG images are read by
:mod:`dgpmp2_tpu_torch.data.png`, other formats by matplotlib, imported only
then.  Draws from a ``np.random.default_rng(seed)`` in the JAX package's
order.

    python -m dgpmp2_tpu_torch.data.generate_im --out_folder d \
        --type multi_obstacle --im_size 128 --num_train 200 --num_test 50
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dgpmp2_tpu_torch import native
from dgpmp2_tpu_torch.data import dataset as ds
from dgpmp2_tpu_torch.data import png


def one_obstacle(rng, im_size):
    im = np.ones((im_size, im_size))
    s = int(0.3 * im_size)
    lo, hi = int(0.2 * im_size), int(0.8 * im_size) - (s + 1)
    x, y = rng.integers(lo, hi, 2)
    im[y : y + s, x : x + s] = 0
    return im


def one_obstacle_size(rng, im_size):
    im = np.ones((im_size, im_size))
    s = int(rng.uniform(0.15, 0.45) * im_size)
    lo, hi = int(0.2 * im_size), int(0.8 * im_size)
    cx, cy = rng.integers(lo, hi, 2)
    im[max(0, cy - s // 2) : cy + s // 2, max(0, cx - s // 2) : cx + s // 2] = 0
    return im


def multi_obstacle(rng, im_size):
    im = np.ones((im_size, im_size))
    n = int(rng.integers(1, 4))
    for _ in range(n):
        f = 0.3 if n == 1 else rng.uniform(0.1, 0.3)
        s = int(f * im_size)
        lo, hi = int(0.1 * im_size), int(0.9 * im_size) - (s + 1)
        x, y = rng.integers(lo, hi, 2)
        im[y : y + s, x : x + s] = 0
    return im


def _imread(path):
    if path.lower().endswith(".png"):
        return png.read_png(path)
    import matplotlib.pyplot as plt

    return plt.imread(path)


def image_folder(rng, im_size, files):
    f = files[int(rng.integers(0, len(files)))]
    img = _imread(f)
    if img.ndim > 2:
        img = img[..., :3] @ np.array([0.299, 0.587, 0.114])
    # Nearest-neighbour resize.
    ys = (np.arange(im_size) * img.shape[0] / im_size).astype(int)
    xs = (np.arange(im_size) * img.shape[1] / im_size).astype(int)
    return np.asarray(img[np.ix_(ys, xs)] > 0.5, float)


GENERATORS = {
    "one_obstacle": one_obstacle,
    "one_obstacle_size": one_obstacle_size,
    "multi_obstacle": multi_obstacle,
}


def generate(out_folder, gen_type, im_size, num_train, num_test,
             im_folder=None, seed=0, x_extent=10.0):
    """Write ``num_train`` and ``num_test`` (im, sdf) worlds under
    ``out_folder``/{train,test}."""
    rng = np.random.default_rng(seed)
    res = x_extent / im_size
    files = None
    if gen_type == "image":
        files = sorted(
            os.path.join(im_folder, f) for f in os.listdir(im_folder)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
    for mode, n in (("train", num_train), ("test", num_test)):
        sub = os.path.join(out_folder, mode)
        os.makedirs(sub, exist_ok=True)
        for i in range(n):
            if gen_type == "image":
                im = image_folder(rng, im_size, files)
            else:
                im = GENERATORS[gen_type](rng, im_size)
            sdf = native.sdf_2d(im > 0.75, res=res)
            ds.save_env(sub, i, im, sdf)
        ds.save_meta(sub, n, 0, im_size, extra={"type": gen_type})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_folder", required=True)
    p.add_argument("--type", default="multi_obstacle",
                   choices=[*GENERATORS, "image"])
    p.add_argument("--im_size", type=int, default=128)
    p.add_argument("--num_train", type=int, default=200)
    p.add_argument("--num_test", type=int, default=50)
    p.add_argument("--im_folder", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    generate(args.out_folder, args.type, args.im_size, args.num_train,
             args.num_test, args.im_folder, args.seed)
    print(f"im/sdf dataset written to {os.path.abspath(args.out_folder)}")


if __name__ == "__main__":
    main()
