"""Runnable examples of the port, one a scenario of the JAX package's
``examples/``: ``python -m repro_torch.examples.<name> [--device cpu]``.

Each has a ``main(argv=None) -> int``, runs on the CUDA device unless
given ``--device`` (and raises without one), seeds its own
``torch.Generator``, and writes only into the directory given as ``--out``
or a temporary one.
"""
