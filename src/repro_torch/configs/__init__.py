"""Model configurations of the port: the ``CONFIG`` constants of repro's
``configs/`` for the models the port runs, each with its ``SOURCE``.
repro's ``ArchSpec`` registry imports JAX; its port waits for the rest of
the model families (ROADMAP Queue 1)."""
