"""The port's counterparts of the JAX package's campaign and sweep tools
(``tools/*.py`` at the repo root), one module per tool and with the same
file names.

Each runs as ``python -m dgpmp2_tpu_torch.tools.<name> --out DIR`` on the
card (``--device cuda``, the default; without a card it raises) in float32
(``--dtype``), and on the CPU only when asked (``--device cpu``).
Importing a module runs nothing: its ``main(argv=None)`` parses the flags,
runs the tool, prints what the JAX tool prints, writes the same files under
``--out`` (the same YAML keys, the same tables) and returns the summary
numbers as a dict.  Learned models are written as the JAX package's flat
``<name>_vars.npz`` (``learn.checkpoints.save_flat_variables``), so that a
model trained by either package loads in the other.  :data:`TOOLS` lists
them in dependency order: a tool imports only tools before it.
"""

TOOLS = (
    "learned_campaign",
    "plan3d_sweep",
    "learn3d_campaign",
    "multistart_sweep",
    "init_experiment",
    "arm_campaign",
    "arm_multistart_eval",
    "headline_campaign",
)
