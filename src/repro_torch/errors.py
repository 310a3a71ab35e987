"""Typed errors of the port (a copy of `repro/errors.py`'s hierarchy).

Library code raises these instead of bare ``assert``, which vanishes under
``python -O``.  Everything subclasses ``ValueError`` so ``except ValueError``
call sites keep working.
"""


class ReproError(Exception):
    """Root of the error hierarchy."""


class ConfigError(ReproError, ValueError):
    """Invalid run/launch configuration (bad flag combination, unknown
    mode, an architecture the port does not cover yet, ...)."""


class ShapeError(ReproError, ValueError):
    """A shape/dtype/device contract was violated (kernel operands, model
    inputs, parameter definitions)."""


class LayoutError(ReproError, ValueError):
    """Flat parameter-layout misuse (wrong tree structure, empty trees)."""
