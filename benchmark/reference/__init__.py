"""The plain reference that decides ``correct``.

``lm.py`` is the full-graph LM step written from the factors' definitions:
its Jacobians come from autograd, its normal equations are assembled with
``index_add_`` and solved in float64. ``slam/`` is a frozen copy of the
program's plain modules for what the program derives from an image (the
networks, the feature and depth pyramids, the configuration), imported from
here and never from the program; ``frames.py`` drives it. ``refine.py``
recomputes what the BA cell's timed path produced and holds the cell's
limits; ``compare.py`` holds the distances compared. Nothing here imports
``jax``, the JAX package or the program.
"""
