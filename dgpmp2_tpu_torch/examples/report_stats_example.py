"""Evaluation results across epochs against the best fixed covariance:
port of ``examples/report_stats_example.py``.  Reads the results YAMLs
that ``dgpmp2_tpu_torch.learn.test_planner`` writes (the epoch is the
number in a file's name, 0 where there is none) and, where it exists, the
sensitivity sweep's YAML (``dgpmp2_tpu_torch.data.sensitivity``), prints
a comparison table and, with ``--plot``, the solve rate by epoch.  Host
work only: it takes no device.

    python -m dgpmp2_tpu_torch.examples.report_stats_example
        [--results_glob 'runs/exp1/results_epoch*.yaml']
        [--sensitivity_file sensitivity_results.yaml] [--plot]
"""
from __future__ import annotations

import argparse
import glob
import os

import yaml

from dgpmp2_tpu_torch.examples import _common


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results_glob", default="runs/exp1/results_epoch*.yaml")
    p.add_argument("--sensitivity_file", default="sensitivity_results.yaml")
    p.add_argument("--plot", action="store_true",
                   help=f"write the figure to {_common.OUT_DIR}")
    args = p.parse_args(argv)

    rows = []
    for f in sorted(glob.glob(args.results_glob)):
        with open(f) as fp:
            r = yaml.safe_load(fp)
        digits = "".join(c for c in os.path.basename(f) if c.isdigit())
        rows.append((int(digits or 0), r))

    baseline = None
    if os.path.exists(args.sensitivity_file):
        with open(args.sensitivity_file) as fp:
            sens = yaml.safe_load(fp)
        baseline = sens["best"]
        print(f"best static baseline (sigma={sens['best_sigma']}): "
              f"solve_rate={baseline['solve_rate']:.3f}")

    if not rows:
        print("no results files matched", args.results_glob)
        return {"rows": [], "baseline": baseline}
    print(f"{'epoch':>6} {'solve_rate':>10} {'gp_error':>10} {'in_coll':>8}")
    for epoch, r in rows:
        print(f"{epoch:>6} {r['solve_rate']:>10.3f} "
              f"{r['avg_gp_error']:>10.4f} {r['avg_in_coll']:>8.3f}")
    if args.plot:
        plt, fig, ax = _common.figure()
        ax.plot([e for e, _ in rows], [r["solve_rate"] for _, r in rows],
                "o-", label="learned")
        if baseline:
            ax.axhline(baseline["solve_rate"], color="gray", linestyle="--",
                       label="best static sigma")
        ax.set_xlabel("epoch")
        ax.set_ylabel("solve rate")
        ax.legend()
        _common.save(plt, fig, "report_stats.png")
    return {"rows": rows, "baseline": baseline}


if __name__ == "__main__":
    main()
