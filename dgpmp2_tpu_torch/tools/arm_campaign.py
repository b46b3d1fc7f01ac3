"""Learned-vs-static campaign on the articulated planar arm.

Port of the JAX package's ``tools/arm_campaign.py``.  The point-robot
campaigns (``learned_campaign``) show the learned covariances beat the best
static sigma; this tool shows the SAME learning stack is robot-generic:
joint-space GP prior, FK collision spheres along both links, the obstacle
factor chaining through the FK Jacobian (``robots.PlanarArm2Link``), none
of the learning code changed.  The reference ships no articulated robot.

Pipeline (one card):
  1. generate arm problems: random box worlds in the reachable annulus,
     rejection-sampled collision-free joint start/goal configs, expert
     labels from the framework's own multistart planner (K seeds,
     contact-free winners only)
  2. static-covariance sensitivity sweep on the held-out test split
  3. train learned configs (the eps_bounded recipe of the point campaigns)
  4. evaluate on the test split with the reference metric suite

Usage:
  python -m dgpmp2_tpu_torch.tools.arm_campaign --out runs/arm_campaign \\
      [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from dgpmp2_tpu_torch.core import gn, graph, multistart
from dgpmp2_tpu_torch.learn import checkpoints
from dgpmp2_tpu_torch.learn.eval import evaluate_batch
from dgpmp2_tpu_torch.learn.learned_planner import (LearnedDiffGPMP2Planner,
                                                    LearnedPlannerConfig)
from dgpmp2_tpu_torch.learn.losses import LossWeights
from dgpmp2_tpu_torch.learn.train import (TrainConfig, init_train_state,
                                          make_optimizer, make_train_step)
from dgpmp2_tpu_torch.ops import sdf as sdf_ops
from dgpmp2_tpu_torch.robots import PlanarArm2Link
from dgpmp2_tpu_torch.tools import _common
from dgpmp2_tpu_torch.tools._common import (dump_yaml, fixed_params,
                                            load_yaml, merged, on_device,
                                            straight)
from dgpmp2_tpu_torch.tools.learned_campaign import best_of, results_table

LIMS = (-5.0, 5.0)
IM = 128
RES = (LIMS[1] - LIMS[0]) / IM
ARM = PlanarArm2Link(link_lengths=(2.5, 2.0), spheres_per_link=3,
                     sphere_radii=(0.25,) * 6)
COV = dict(qc_inv=np.eye(2), cost_sigma=0.05, epsilon_dist=0.2,
           k_s=0.01, k_g=0.01)
SIGMAS = [0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0]
T_STEP = 40
ITERS = 50  # GN iterations of each plan but the expert's (LM, 60)
KEYS = ("im", "sdf", "start", "goal", "th_opt")


def arm_spec() -> graph.GraphSpec:
    return graph.GraphSpec(total_time_step=T_STEP, nlinks=ARM.nlinks)


def fk_np(q):
    """Numpy FK for rejection sampling: (..., 2) joints -> (..., 6, 2)."""
    l1, l2 = ARM.link_lengths
    n = ARM.spheres_per_link
    fr = (np.arange(n) + 1.0) / n
    q1, q12 = q[..., 0], q[..., 0] + q[..., 1]
    e1 = np.stack([np.cos(q1), np.sin(q1)], -1)  # (..., 2)
    e2 = np.stack([np.cos(q12), np.sin(q12)], -1)
    link1 = fr[:, None] * l1 * e1[..., None, :]            # (..., n, 2)
    link2 = l1 * e1[..., None, :] + fr[:, None] * l2 * e2[..., None, :]
    return np.concatenate([link1, link2], axis=-2)


def world_to_pix(pts):
    """(..., 2) world xy -> (row, col) float pixel coords (y flipped)."""
    col = (pts[..., 0] - LIMS[0]) / RES
    row = (-LIMS[0] - pts[..., 1]) / RES
    return row, col


def gen_world(rng):
    """One random box world in the arm's reachable annulus."""
    img = np.ones((IM, IM), np.float32)
    placed, tries = 0, 0
    want = rng.integers(3, 6)
    while placed < want and tries < 60:
        tries += 1
        cx, cy = rng.uniform(-4.2, 4.2, 2)
        r = np.hypot(cx, cy)
        if not (1.8 <= r <= 4.2):
            continue
        w, h = rng.uniform(0.7, 1.6, 2)
        # A clear disc around the base, so that link 1 is not born in
        # contact.
        corners = np.array([[cx - w / 2, cy - h / 2],
                            [cx + w / 2, cy + h / 2]])
        if np.min(np.hypot(*np.meshgrid(corners[:, 0],
                                        corners[:, 1]))) < 1.1:
            continue
        r0, c0 = world_to_pix(np.array([cx - w / 2, cy + h / 2]))
        r1, c1 = world_to_pix(np.array([cx + w / 2, cy - h / 2]))
        rr0, rr1 = int(max(0, r0)), int(min(IM, r1))
        cc0, cc1 = int(max(0, c0)), int(min(IM, c1))
        if rr1 <= rr0 or cc1 <= cc0:
            continue
        img[rr0:rr1, cc0:cc1] = 0.0
        placed += 1
    return img


def sample_config(rng, sdf_np, margin, avoid=None, min_dist=1.2, tries=200):
    """Rejection-sample one collision-free joint config against a numpy
    SDF (nearest-pixel clearance: a generous margin absorbs the
    approximation)."""
    for _ in range(tries):
        q = np.array([rng.uniform(-np.pi, np.pi), rng.uniform(-2.4, 2.4)])
        if avoid is not None and np.linalg.norm(q - avoid) < min_dist:
            continue
        row, col = world_to_pix(fk_np(q))  # (6, 2) sphere centres
        ri = np.clip(np.round(row).astype(int), 0, IM - 1)
        ci = np.clip(np.round(col).astype(int), 0, IM - 1)
        if np.min(sdf_np[ri, ci]) > margin:
            return q
    return None


def world_sdf(img, dev) -> torch.Tensor:
    """The float32 SDF of one occupancy image, or a batch of them."""
    return sdf_ops.sdf_from_occupancy(
        torch.as_tensor(img, dtype=torch.float32, device=dev), res=RES)


@torch.no_grad()
def gen_problems(n, seed, spec, chunk=512, restarts=8, amp=1.2,
                 device="cuda", dtype=torch.float32):
    """``n`` expert-labeled arm problems (a world each), as numpy arrays:
    multistart LM experts over chunks of ``chunk`` worlds, contact-free
    winners only."""
    rng = np.random.default_rng(seed)
    margin = ARM.sphere_radii[0] + COV["epsilon_dist"] + 0.06
    cfg = gn.OptimConfig(reg=0.1, max_iters=60, method="lm")
    out = {k: [] for k in KEYS}
    kept = chunks = 0
    while kept < n:
        ims, starts, goals = [], [], []
        while len(ims) < chunk:
            img = gen_world(rng)
            sdf_np = world_sdf(img, device).cpu().numpy()
            qs = sample_config(rng, sdf_np, margin)
            if qs is None:
                continue
            qg = sample_config(rng, sdf_np, margin, avoid=qs)
            if qg is None:
                continue
            ims.append(img)
            starts.append(np.concatenate([qs, [0.0, 0.0]]))
            goals.append(np.concatenate([qg, [0.0, 0.0]]))
        b = on_device({"start": np.stack(starts).astype(np.float32),
                       "goal": np.stack(goals).astype(np.float32)},
                      device, dtype)
        b["sdf"] = world_sdf(np.stack(ims), device).to(dtype).contiguous()
        res = multistart.plan_multistart(
            spec, ARM, fixed_params(spec, ARM, b, COV),
            straight(spec, b["start"], b["goal"]), b["sdf"], cfg,
            _common.generator(device, seed, chunks), restarts=restarts,
            amp=amp)
        chunks += 1
        th = res.th.cpu().numpy()
        ok = (res.contact_free.cpu().numpy()
              & np.isfinite(th.reshape(len(ims), -1)).all(-1))
        print(f"[gen] chunk: expert solved {ok.sum()}/{len(ims)}", flush=True)
        out["im"].append(np.stack(ims)[ok])
        out["sdf"].append(b["sdf"].cpu().numpy()[ok])
        out["start"].append(np.stack(starts)[ok].astype(np.float32))
        out["goal"].append(np.stack(goals)[ok].astype(np.float32))
        out["th_opt"].append(th[ok])
        kept += int(ok.sum())
    return {k: np.concatenate(v)[:n] for k, v in out.items()}


def as_batches(data, idxs, bs, rng=None):
    """Numpy batches of ``bs`` problems (the short last one dropped)."""
    if rng is not None:
        idxs = rng.permutation(idxs)
    for i in range(0, len(idxs) - bs + 1, bs):
        sel = idxs[i:i + bs]
        yield {k: v[sel] for k, v in data.items()}


def batches_on(data, bs, dev, dtype, idxs=None):
    """:func:`as_batches` in index order, on ``dev``."""
    idxs = np.arange(len(data["im"])) if idxs is None else idxs
    return [on_device(b, dev, dtype) for b in as_batches(data, idxs, bs)]


@torch.no_grad()
def static_sweep(spec, test, bs, out_file, dev="cuda", dtype=torch.float32):
    """Per-sigma metrics of the static planner on the test problems (read
    back from ``out_file`` where it exists)."""
    cached = load_yaml(out_file)
    if cached is not None:
        return cached
    cfg = gn.OptimConfig(reg=0.1, max_iters=ITERS)
    batches = batches_on(test, bs, dev, dtype)
    results = {}
    for sigma in SIGMAS:
        all_m = []
        for b in batches:
            th = gn.plan(spec, ARM,
                         fixed_params(spec, ARM, b, dict(COV,
                                                         cost_sigma=sigma)),
                         straight(spec, b["start"], b["goal"]), b["sdf"],
                         cfg, track_best=True).best_th
            all_m.append(evaluate_batch(spec, ARM,
                                        fixed_params(spec, ARM, b, COV), th,
                                        b["th_opt"], b["sdf"]))
        results[float(sigma)] = merged(all_m)
        print(f"[static] sigma={sigma}: solve="
              f"{results[float(sigma)]['solve_rate']:.3f} contact_free="
              f"{results[float(sigma)]['contact_free_rate']:.3f}", flush=True)
    dump_yaml(out_file, results)
    return results


@torch.no_grad()
def learned_plans(planner, variables, b, params):
    return planner.plan(variables, params,
                        straight(planner.spec, b["start"], b["goal"]),
                        b["sdf"], b["im"], max_iters=ITERS,
                        track_best=True)[0]


def _val_rates(planner, variables, spec, val_batches):
    """(solve, contact-free) rates of the learned plans on the val split."""
    solves, cfree = [], []
    for b in val_batches:
        params = fixed_params(spec, ARM, b, COV)
        m = evaluate_batch(spec, ARM, params,
                           learned_plans(planner, variables, b, params),
                           b["th_opt"], b["sdf"])
        solves.append(~m["in_coll"].astype(bool))
        cfree.append(~m["in_contact"].astype(bool))
    return (float(np.mean(np.concatenate(solves))),
            float(np.mean(np.concatenate(cfree))))


def make_planner(lcfg_over, device="cuda", dtype=torch.float32):
    lcfg = LearnedPlannerConfig(dynamics_mode="diag_identity",
                                dropout_prob=0.1, dtype=dtype, **lcfg_over)
    return LearnedDiffGPMP2Planner(arm_spec(), ARM,
                                   gn.OptimConfig(reg=0.1, max_iters=ITERS),
                                   lcfg, device=device)


def train_config(name, w_over, lcfg_over, train, args, out_dir):
    """Train one config (or load its ``<name>_vars.npz``), keeping the
    epoch of the best (solve, contact-free) val rates.  Returns (planner,
    state)."""
    dev, dtype = args.device, args.dtype
    w_over = dict(w_over)
    alpha = w_over.pop("_alpha", args.alpha)
    ckpt = os.path.join(out_dir, f"{name}_vars.npz")
    planner = make_planner(lcfg_over, dev, dtype)
    spec = planner.spec
    rng_np = np.random.default_rng(123)
    all_idxs = rng_np.permutation(len(train["im"]))
    n_val = max(args.batch, len(all_idxs) // 10)
    n_val -= n_val % args.batch
    # Tiny-split guard: keep at least one training batch.
    n_val = min(n_val, len(all_idxs) - args.batch)
    val_idxs, idxs = all_idxs[:n_val], all_idxs[n_val:]
    if n_val <= 0:  # smoke runs: reuse the train batch for epoch selection
        val_idxs = idxs[:args.batch]
    val_batches = batches_on(train, args.batch, dev, dtype, val_idxs)

    train_step = make_train_step(planner, LossWeights(**w_over),
                                 TrainConfig(T=args.unroll, tk=args.tk,
                                             use_inter_loss=True))
    sample = on_device(next(as_batches(train, idxs, args.batch)), dev, dtype)
    state = init_train_state(
        planner, make_optimizer("adam", {"alpha": alpha}),
        torch.Generator().manual_seed(0),
        planner.stack_inputs(sample["im"], sample["sdf"]), sample["th_opt"])
    if os.path.exists(ckpt):
        checkpoints.load_flat_variables(ckpt, state.variables)
        print(f"[train:{name}] loaded checkpoint, skipping training")
        return planner, state

    best = _val_rates(planner, state.variables, spec, val_batches)
    best_vars = _common.state_copy(state.variables)
    print(f"[train:{name}] {len(idxs)} problems; epoch -1 (init): "
          f"val solve={best[0]:.3f} cfree={best[1]:.3f}", flush=True)
    hist = []
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for b in as_batches(train, idxs, args.batch, rng=rng_np):
            batch = on_device(b, dev, dtype)
            batch["cov_scalars"] = COV
            state, m = train_step(state, batch, 0)
            losses.append(float(m["loss"]))
        hist.append(float(np.mean(losses)))
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            rates = _val_rates(planner, state.variables, spec, val_batches)
            tag = ""
            if rates > best:
                best, tag = rates, " *best*"
                best_vars = _common.state_copy(state.variables)
            print(f"[train:{name}] epoch {epoch}: loss={hist[-1]:.4f} "
                  f"val solve={rates[0]:.3f} cfree={rates[1]:.3f}{tag} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    state.variables.load_state_dict(best_vars)
    print(f"[train:{name}] selected val solve={best[0]:.3f} "
          f"cfree={best[1]:.3f}")
    checkpoints.save_flat_variables(ckpt, state.variables)
    dump_yaml(os.path.join(out_dir, f"{name}_train_loss.yaml"), hist)
    return planner, state


def eval_learned(planner, state, spec, test, bs):
    all_m = []
    for b in batches_on(test, bs, planner.device, planner.learn_cfg.dtype):
        params = fixed_params(spec, ARM, b, COV)
        all_m.append(evaluate_batch(
            spec, ARM, params, learned_plans(planner, state.variables, b,
                                             params),
            b["th_opt"], b["sdf"]))
    return merged(all_m)


def configs_of(best_sigma: float) -> dict:
    """The arm's learned configs, initialised at the static sweep's best
    sigma: name -> (LossWeights overrides, LearnedPlannerConfig
    overrides)."""
    eps_b = dict(learn_eps=True, eps_max=2 * COV["epsilon_dist"],
                 static_init=(1.0, float(best_sigma), COV["epsilon_dist"]))
    eps_a = dict(learn_eps=True,
                 static_init=(1.0, float(best_sigma), COV["epsilon_dist"]))
    task = dict(pos_loss_weight=0.0, ext_loss_weight=1.0, ext_obs_lambda=5.0)
    return {
        "eps_bounded": (task, eps_b),
        "eps_anchor": (dict(task, pos_loss_weight=0.05), eps_a),
        # At 3e-4 the arm losses oscillate (eps_bounded) or diverge
        # (eps_anchor), and epoch selection falls back to the init weights.
        "eps_bounded_lr1": (dict(task, _alpha=1e-4), eps_b),
        "eps_bounded_lr2": (dict(task, _alpha=3e-5), eps_b),
        "eps_anchor_lr1": (dict(task, pos_loss_weight=0.05, _alpha=1e-4),
                           eps_a),
    }


def main(argv=None) -> dict:
    p = _common.parser(__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--num_train", type=int, default=2048)
    p.add_argument("--num_test", type=int, default=512)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--alpha", type=float, default=3e-4)
    p.add_argument("--unroll", type=int, default=10)
    p.add_argument("--tk", type=int, default=5)
    p.add_argument("--eval_every", type=int, default=4)
    p.add_argument("--configs", nargs="+",
                   default=["eps_bounded", "eps_anchor"])
    args = _common.parse(p, argv)
    dev, dtype = args.device, args.dtype

    os.makedirs(args.out, exist_ok=True)
    spec = arm_spec()
    splits = {}
    for mode, n, seed in (("train", args.num_train, 0),
                          ("test", args.num_test, 777)):
        path = os.path.join(args.out, f"data_{mode}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                splits[mode] = {k: z[k] for k in z.files}
            print(f"[data] {mode}: loaded {len(splits[mode]['im'])}")
        else:
            t0 = time.time()
            splits[mode] = gen_problems(n, seed, spec, device=dev,
                                        dtype=dtype)
            np.savez_compressed(path, **splits[mode])
            print(f"[data] {mode}: {n} problems in {time.time() - t0:.0f}s")

    static = static_sweep(spec, splits["test"], args.batch,
                          os.path.join(args.out, "static_sensitivity.yaml"),
                          dev, dtype)
    best_sigma = best_of(static)
    print(f"[static] best sigma={best_sigma}: {static[best_sigma]}")
    configs = configs_of(best_sigma)

    results_file = os.path.join(args.out, "results.yaml")
    results = load_yaml(results_file) or {}
    results["static_best"] = {"sigma": float(best_sigma),
                              **static[best_sigma]}
    for name in args.configs:
        w_over, lcfg_over = configs[name]
        planner, state = train_config(name, w_over, lcfg_over,
                                      splits["train"], args, args.out)
        summary = eval_learned(planner, state, planner.spec, splits["test"],
                               args.batch)
        results[name] = summary
        print(f"[eval:{name}] {json.dumps(summary)}")
        dump_yaml(results_file, results)

    table = results_table(results)
    with open(os.path.join(args.out, "table.md"), "w") as fp:
        fp.write(table + "\n")
    print(table)
    return results


if __name__ == "__main__":
    main()
