"""``rebound(fn, **names)``: ``fn`` run with some of its module's names bound to other
objects.  The Fourier cell's pieces are the 1D cascade's functions with the cascade,
the parameter spec or the FLOP count swapped: the same code, so that the two cells'
drivers, weights and training loops cannot drift apart."""

from __future__ import annotations

import types


def rebound(fn: types.FunctionType, **names) -> types.FunctionType:
    """A copy of the module-level function ``fn`` whose global names ``names`` refer to
    the given objects; its other globals are its module's as they are now."""
    if fn.__closure__:
        raise ValueError(f"{fn.__qualname__} is not a module-level function")
    missing = [n for n in names if n not in fn.__globals__]
    if missing:
        raise KeyError(f"{fn.__module__} has no global {missing}")
    out = types.FunctionType(fn.__code__, {**fn.__globals__, **names}, fn.__name__,
                             fn.__defaults__)
    out.__kwdefaults__, out.__doc__ = fn.__kwdefaults__, fn.__doc__
    return out
