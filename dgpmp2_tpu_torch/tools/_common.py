"""What the campaign and sweep tools share: the device and dtype flags,
batches on the device, the straight seed and fixed covariances of a batch,
the merged metric suite and YAML files."""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import yaml

from dgpmp2_tpu_torch.core import graph
from dgpmp2_tpu_torch.learn.eval import summarize
from dgpmp2_tpu_torch.utils.trajectory import straight_line_traj

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parser(doc: str) -> argparse.ArgumentParser:
    """A tool's parser with ``--device`` (the card unless ``cpu`` is given;
    no fallback) and ``--dtype`` (float32, which the JAX tools fix)."""
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    return p


def parse(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv``; ``device`` and ``dtype`` come back as torch objects.
    A CUDA device on a host without one raises here."""
    args = p.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tools run on the card unless "
                           "--device cpu is given")
    args.dtype = DTYPES[args.dtype]
    return args


def flags(args: argparse.Namespace) -> list:
    """The ``--device`` and ``--dtype`` of parsed ``args``, for the argv of
    another tool's ``main``."""
    name = next(k for k, v in DTYPES.items() if v == args.dtype)
    return ["--device", str(args.device), "--dtype", name]


def on_device(batch: dict, dev, dtype) -> dict:
    """A numpy batch as tensors on ``dev``, floating arrays in ``dtype``."""
    return {k: torch.as_tensor(
        v, device=dev,
        dtype=dtype if np.asarray(v).dtype.kind == "f" else None)
        for k, v in batch.items()}


def straight(spec: graph.GraphSpec, start, goal) -> torch.Tensor:
    """The straight-line seeds of (B, D) start and goal states."""
    return straight_line_traj(start[:, :spec.dof], goal[:, :spec.dof],
                              spec.total_time_sec, spec.total_time_step)


def fixed_params(spec, robot, batch: dict, cov: dict) -> graph.GraphParams:
    """The fixed covariances ``cov`` of a batch, in its dtype."""
    return graph.default_params(spec, robot, batch["start"], batch["goal"],
                                **cov, dtype=batch["start"].dtype)


def generator(dev, seed: int, index: int = 0) -> torch.Generator:
    """A generator on ``dev`` for draw ``index`` of a run seeded ``seed``
    (where the JAX tools fold ``index`` into ``PRNGKey(seed)``)."""
    gen = torch.Generator(dev)
    gen.manual_seed(int(np.random.SeedSequence([seed, index])
                        .generate_state(1, np.uint64)[0]))
    return gen


def merged(all_m: list) -> dict:
    """``learn.eval.summarize`` of per-batch metric dicts, concatenated."""
    return summarize({k: np.concatenate([m[k] for m in all_m])
                      for k in all_m[0]})


def load_yaml(path: str, default=None):
    """The YAML at ``path``, or ``default`` where there is none."""
    if not os.path.exists(path):
        return default
    with open(path) as fp:
        return yaml.safe_load(fp)


def dump_yaml(path: str, obj) -> None:
    with open(path, "w") as fp:
        yaml.safe_dump(obj, fp)


def state_copy(module: torch.nn.Module) -> dict:
    """A detached copy of a module's weights (a best epoch's)."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}
