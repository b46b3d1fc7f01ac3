"""The port's counterparts of the JAX package's ``examples/``, one module
per program and with the same file names.

Each runs as ``python -m dgpmp2_tpu_torch.examples.<name>`` on the card
(``--device cuda``, the default) in float32 (``--dtype``), and on the CPU
only when asked (``--device cpu``).  Importing a module runs nothing: its
``main(argv=None)`` parses the flags, runs the example, prints what the
JAX program prints and returns those numbers as a dict.  ``--plot`` writes
the figures to ``dgpmp2_tpu_torch/examples/out/``; nothing imports
matplotlib otherwise.  :data:`EXAMPLES` lists them in the order of the
groups they fall in, from the classic planner to the learned one.
"""

EXAMPLES = (
    "gpmp2_2d_example",
    "gpmp2_2d_step_example",
    "diff_gpmp2_2d_example",
    "diff_gpmp2_2d_step_example",
    "diff_gpmp2_2d_batch_example",
    "diff_gpmp2_2d_batch_step_example",
    "diff_gpmp2_2d_vel_limits_example",
    "diff_gpmp2_gp_inter_example",
    "diff_gpmp2_nonholonomic_example",
    "planar_arm_example",
    "self_collision_example",
    "arm_taskspace_example",
    "rrt_star_example",
    "multistart_example",
    "plan3d_example",
    "replanning_example",
    "serving_example",
    "dataset_loading_example",
    "diff_gpmp2_multi_dataset_example",
    "learned_vs_static_example",
    "report_stats_example",
)
