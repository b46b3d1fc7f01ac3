"""The generation of the process-wide settings that change what a plan
launches.

Each setter of such a setting (``ops.sdf.set_lookup_method``,
``set_lookup3d_method`` and ``set_oob_mode``; ``ops.cuda.btd_stream.
set_rows_plan`` and ``set_producers``) calls :func:`changed`.
``core.gn`` puts :data:`generation` in the key of a captured plan, so that
the first plan after a change runs eagerly and is captured anew.
"""

generation = 0


def changed() -> None:
    """Mark a change of a process-wide setting."""
    global generation
    generation += 1
