"""The control of ``correct``: the reference put in the program's place and
computed one precision below the configuration's (bfloat16 for float32),
through the cell's own pool, batch, check and limits.  It has to come out
not correct.  The benchmark's runs never run it.

    python3 -m portbench.control --workload <cell> --seed <n> [<n> ...]

prints one JSON line per seed: the numbers compared and whether the limits
held.  One call a seed, at the cell's batch: as many answers as a run's
check compares, or more.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import spec

BELOW = {"float64": "float32", "float32": "bfloat16"}


def read(cell, seed: int, dtype, device) -> dict:
    """Plan one call of the cell with the reference in ``dtype`` and check
    it as a run checks the program's."""
    import torch

    driver = spec.system(cell.config).Driver(cell, seed, device)
    driver.release()
    driver.entry = spec.system(cell.config).reference_entry(driver, dtype)
    with torch.no_grad():
        records = [driver.call(0)]
        compared = driver.check(records, int(cell.settings["check_problems"]),
                                int(cell.settings["check_block"]))
    limits = cell.settings["limits"]
    return {"seed": seed, "dtype": str(dtype).split(".")[-1],
            "problems": sum(r.idx.numel() for r in records),
            "seconds": records[0].seconds,
            "compared": compared,
            "correct": all(compared[k] <= limits[k] for k in limits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    dtype = getattr(torch, BELOW[cell.config["dtype"]])
    for seed in args.seed:
        print(json.dumps(read(cell, seed, dtype, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
