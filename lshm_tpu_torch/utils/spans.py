"""Named host spans at the port's layer boundaries, recorded only while a profiler runs.

``span(name)`` opens a ``torch.autograd.profiler.record_function`` range of that name
(scope ``USER_SCOPE``) when a ``torch.profiler`` session is recording, on the
profiler's clock beside the device's activity; otherwise it returns one shared no-op
context manager.  There is no switch: spans appear in any session that records host
ranges (the CLI's ``--profile-dir``, an operator's own ``torch.profiler.profile``, a
profiler driven at the user scope alone).  A session of the CUDA activity alone opens
the ranges but records none of them.  Spans nest per thread; a span opened before a
session starts is not recorded, and one still open when it stops ends there.

A span still open when its session stops and another starts is not ended: torch 2.11
can segfault when a range is ended under a later session than the one it began in
(seen with sessions of the user scope alone on all threads).  Each span notes the
session it began in, counted by wrapping
``torch.autograd.profiler._run_on_profiler_start`` (which every ``torch.profiler``
session calls as it starts), and one that ends in another session is kept, unended,
for the life of the process, since dropping the range would end it.

The test is ``torch.autograd.profiler._is_profiler_enabled``, the process-wide flag
that every ``torch.profiler`` session sets at its start and clears at its stop (the
check PyTorch's own compiled graphs make before they open a range): unlike
``torch.autograd._profiler_enabled()``, which reads the calling thread's state, it
holds on every thread and under ``profile_all_threads``.  Off, a span and its
``with`` cost about 0.3 us of host time.

Names are ``<layer>.<what>``: ``trainer.*`` (``Trainer.run``, once a minibatch),
``admm.*`` (``train/step.py``, once an ADMM iteration; on CUDA graphs ``admm.replay``
twice and ``admm.optimizer`` once an iteration, ``admm.capture`` once a capture),
``prefetch.*`` (the prefetch thread, ``data/sampler.py``) and ``cascade.*``
(``models/cascade.py``, the Fourier variant's forward: ``cascade.dft`` and
``cascade.aef`` once a forward, inside a CUDA graph's capture but not its replays).
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_session = 0          # sessions started in this process
_crossed: list = []   # ranges begun in an earlier session than the one they ended in


def _count_session(start=_profiler._run_on_profiler_start):
    global _session
    _session += 1
    start()


_profiler._run_on_profiler_start = _count_session


class _Span:
    __slots__ = ("range", "session")

    def __init__(self, name: str):
        self.range = _profiler.record_function(name)

    def __enter__(self):
        self.session = _session
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.session == _session or not _profiler._is_profiler_enabled:
            self.range.__exit__(*exc)
        else:
            _crossed.append(self.range)


def span(name: str):
    """A context manager: the profiler range ``name`` while a session records, else
    the shared no-op."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF
