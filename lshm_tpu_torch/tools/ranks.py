"""Start the ranks of a process group on this host and wait for them.

``run_ranks(argv, world, timeout)`` starts ``world`` processes of one command with
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set (what ``torchrun`` sets, so that
``init_distributed`` finds them) and each ``{rank}`` in ``argv`` replaced by the rank,
waits for all of them, and when one fails or the time
runs out kills the others, so that no rank is left waiting in a collective.  The command
names its own rendezvous (a ``file://`` store, or ``MASTER_ADDR``/``MASTER_PORT`` in
``env``).  ``chip_smoke.py`` and the CPU tests launch their ranks with it.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Sequence


def run_ranks(argv: Sequence[str], world: int, timeout: float,
              env: dict[str, str] | None = None,
              local_ranks: Sequence[int] | None = None,
              cwd: str | None = None) -> list[subprocess.CompletedProcess]:
    """Run ``argv`` as ranks 0..world-1; returns each rank's completed process (stdout
    and stderr as text).  ``local_ranks`` default to the ranks (one card each).  Raises
    ``TimeoutError`` (with the ranks' output so far) after ``timeout`` seconds."""
    local_ranks = list(range(world)) if local_ranks is None else list(local_ranks)
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(world)]
    procs: list[subprocess.Popen] = []
    timed_out = False
    try:
        for rank, (out, err) in enumerate(logs):
            penv = {**os.environ, **(env or {}), "WORLD_SIZE": str(world),
                    "RANK": str(rank), "LOCAL_RANK": str(local_ranks[rank])}
            cmd = [a.replace("{rank}", str(rank)) for a in argv]
            procs.append(subprocess.Popen(cmd, env=penv, cwd=cwd, stdout=out, stderr=err,
                                          text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break                      # one rank failed: the others would wait
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        done = _collect(procs, logs)
        for out, err in logs:
            out.close()
            err.close()
    if timed_out:
        raise TimeoutError(f"ranks still running after {timeout} s:\n" + _tails(done))
    return done


def _collect(procs, logs) -> list[subprocess.CompletedProcess]:
    done = []
    for p, (out, err) in zip(procs, logs):
        out.seek(0)
        err.seek(0)
        done.append(subprocess.CompletedProcess(p.args, p.returncode, out.read(),
                                                err.read()))
    return done


def _tails(done: list[subprocess.CompletedProcess], chars: int = 3000) -> str:
    return "\n".join(f"--- rank {r} (exit {c.returncode})\n{c.stdout[-chars:]}\n"
                     f"{c.stderr[-chars:]}" for r, c in enumerate(done))


def check_ranks(done: list[subprocess.CompletedProcess]) -> list[str]:
    """Each rank's stdout; raises with every rank's output when one failed."""
    if any(c.returncode != 0 for c in done):
        raise RuntimeError("a rank failed:\n" + _tails(done))
    return [c.stdout for c in done]
