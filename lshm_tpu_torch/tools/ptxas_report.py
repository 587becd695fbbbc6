"""Registers, spills and stack frame of every kernel in the CUDA sources, as ptxas
reports them.

    python -m lshm_tpu_torch.tools.ptxas_report [--sass] [conv_head khm conv0]

Compiles each ``lshm_tpu_torch/csrc/<name>.cu`` with the build's flags plus
``-Xptxas -v`` into a temporary directory (the built libraries are left alone), one
``nvcc`` per source, all started together, and prints one JSON line per kernel entry:
the source, the kernel's demangled name without its parameters, registers, barriers,
stack frame, spill stores and spill loads (bytes).  With ``--sass`` each line also
holds ``sass_sha256``, a digest of the kernel's machine code as ``cuobjdump -sass``
lists it: two trees whose kernel has the same digest run the same instructions.
nvcc runs inside ``csrc/`` on the bare file name: the mangled name of a kernel in an
anonymous namespace holds a hash of the source's path as given, and ptxas's register
allocation can follow that name, so two checkouts compiled by absolute path can differ
in machine code that their sources do not.  Needs ``nvcc``; no card.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from lshm_tpu_torch.kernels._build import CSRC, NVCC_FLAGS, SOURCES, _nvcc

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:, used (\d+) barriers)?")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_END = re.compile(r"^\s*\.{5,}\s*$")


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


def sass_digests(listing: str) -> dict[str, str]:
    """{mangled name: SHA-256 (16 hex digits) of its instructions} from a ``cuobjdump
    -sass`` listing; a function's code runs from its "Function :" line to the dotted
    line that closes it."""
    code: dict[str, list[str]] = {}
    cur = None
    for line in listing.splitlines():
        if m := _FUNC.match(line):
            cur = code.setdefault(m.group(1), [])
        elif _END.match(line):
            cur = None
        elif cur is not None and line.strip():
            cur.append(line.strip())
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16]
            for k, v in code.items()}


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
    args = list(argv if argv is not None else sys.argv[1:])
    sass = "--sass" in args
    names = [a for a in args if a != "--sass"] or list(SOURCES)
    nvcc = _nvcc()
    digests: dict[str, dict[str, str]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                      f"{tmp}/lib{n}.so", f"{n}.cu"], cwd=CSRC,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
                 for n in names}
        logs = {n: p.communicate()[0] for n, p in procs.items()}
        failed = [n for n, p in procs.items() if p.returncode != 0]
        if sass:
            cuobjdump = str(Path(nvcc).parent / "cuobjdump")
            for n in set(names) - set(failed):
                digests[n] = sass_digests(subprocess.run(
                    [cuobjdump, "-sass", f"{tmp}/lib{n}.so"], capture_output=True,
                    text=True, check=True).stdout)
    for n in failed:
        print(logs[n], file=sys.stderr)
    for n in names:
        rows = parse(logs[n])
        for row, full in zip(rows, _demangle([r["mangled"] for r in rows])):
            extra = ({"sass_sha256": digests[n].get(row["mangled"])} if n in digests
                     else {})
            print(json.dumps({"source": f"lshm_tpu_torch/csrc/{n}.cu",
                              "kernel": short_name(full),
                              **{k: v for k, v in row.items() if k != "mangled"},
                              **extra}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
