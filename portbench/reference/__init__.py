"""The benchmark's plain reference: what decides ``correct``.

Plain torch only; imports nothing of the program or of JAX, and takes from
the program nothing but its outputs to judge them.
"""
