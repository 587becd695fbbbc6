"""Registers, spills and stack frame of every kernel in the CUDA sources, as ptxas
reports them.

    python -m lshm_tpu_torch.tools.ptxas_report [conv_head khm conv0]

Compiles each ``lshm_tpu_torch/csrc/<name>.cu`` with the build's flags plus
``-Xptxas -v`` into a temporary directory (the built libraries are left alone), one
``nvcc`` per source, all started together, and prints one JSON line per kernel entry:
the source, the kernel's demangled name without its parameters, registers, barriers,
stack frame, spill stores and spill loads (bytes).  Needs ``nvcc``; no card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile

from lshm_tpu_torch.kernels._build import CSRC, NVCC_FLAGS, SOURCES, _nvcc

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:, used (\d+) barriers)?")


def parse(log: str) -> list[dict]:
    """The kernels of one ``-Xptxas -v`` log, in the order ptxas compiled them.  A
    frame line counts only under its own kernel's "Function properties" line (a device
    function that was not inlined has one of its own)."""
    rows, cur, own = [], None, False
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            cur = {"mangled": m.group(1)}
            rows.append(cur)
        elif m := _PROPS.search(line):
            own = cur is not None and m.group(1) == cur["mangled"]
        elif own and (m := _FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _USED.search(line)):
            cur.update(registers=int(m.group(1)), barriers=int(m.group(2) or 0))
    return rows


def short_name(demangled: str) -> str:
    """``void (anonymous namespace)::tc::k<4>(float const*, int)`` -> ``tc::k<4>``."""
    name = demangled.replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    return name.removeprefix("void ").strip()


def _demangle(names: list[str]) -> list[str]:
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt or not names:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout
    return out.splitlines()


def main(argv: list[str] | None = None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(SOURCES)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                      f"{tmp}/lib{n}.so", str(CSRC / f"{n}.cu")],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
                 for n in names}
        logs = {n: p.communicate()[0] for n, p in procs.items()}
    failed = [n for n, p in procs.items() if p.returncode != 0]
    for n in failed:
        print(logs[n], file=sys.stderr)
    for n in names:
        rows = parse(logs[n])
        for row, full in zip(rows, _demangle([r["mangled"] for r in rows])):
            print(json.dumps({"source": f"lshm_tpu_torch/csrc/{n}.cu",
                              "kernel": short_name(full),
                              **{k: v for k, v in row.items() if k != "mangled"}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
