#!/usr/bin/env python3
"""The step loop of a compiled kernel, from its SASS: what one iteration
issues and where its loads sit.

    cuobjdump -sass pygenray_tpu_torch/_build/<lib>.so > lib.sass
    python3 tools/sass_loop.py lib.sass [NAME_PART ...]

For every kernel in the dump whose (mangled) name holds each NAME_PART,
prints one JSON line: the kernel's name (demangled by ``c++filt`` where it is
installed), the step loop's bounds, its instruction count by class, and
the offset of each load, barrier, special-function (MUFU) instruction and
subroutine call inside the loop.  The step loop is the shortest backward
branch whose body holds four or more ``MUFU.RSQ`` (one a right-hand side:
the RK4 stages k2, k3, k4 and the end-of-step derivative).  The counts are
of the straight-line body: branches taken in the common case (around a
division's slow path, around the boundary-crossing fix) skip some of it.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_CLASSES = (
    ("fp32", ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "FCHK", "FSWZADD")),
    ("mufu", ("MUFU",)),
    ("load", ("LDG", "LDS", "LDC", "LD", "LDL", "ULDC")),
    ("store", ("STG", "STS", "STL", "ST")),
    ("barrier", ("BAR", "LDGDEPBAR", "DEPBAR", "LDGSTS", "WARPSYNC")),
    ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BREAK")),
    ("int", ("IADD3", "IMAD", "ISETP", "LOP3", "SHF", "LEA", "SEL", "MOV", "IABS", "I2F", "F2I",
             "PRMT", "P2R", "R2P", "PLOP3", "VOTE", "S2R", "S2UR", "R2UR", "UMOV", "UIADD3",
             "UISETP", "ULOP3", "USEL", "ULEA", "UIMAD", "USHF")),
)


def kernels(text):
    """{mangled name: [(address, opcode, operands), ...]} of a cuobjdump -sass dump."""
    out, name = {}, None
    if "Function :" not in text:  # one kernel's listing, its name on the first line
        name = text.split(None, 1)[0]
        out[name] = []
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INS.search(ln)
        if name and m:
            out[name].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def opclass(op):
    base = op.split(".")[0]
    for cls, ops in _CLASSES:
        if base in ops:
            return cls
    return "other"


def step_loop(ins):
    """(start, end) addresses of the step loop, or None."""
    best = None
    for addr, op, args in ins:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        rsq = sum(1 for a, o, _ in ins if lo <= a <= addr and o == "MUFU.RSQ")
        if rsq >= 4 and (best is None or addr - lo < best[1] - best[0]):
            best = (lo, addr)
    return best


def describe(name, ins):
    loop = step_loop(ins)
    row = {"kernel": name, "instructions": len(ins)}
    if loop is None:
        return {**row, "step_loop": None}
    lo, hi = loop
    body = [(a, o, x) for a, o, x in ins if lo <= a <= hi]
    where = lambda keep: [[a - lo, o] for a, o, _ in body if keep(o)]
    return {
        **row,
        "step_loop": [hex(lo), hex(hi)],
        "loop_instructions": len(body),
        "loop_by_class": dict(Counter(opclass(o) for _, o, _ in body).most_common()),
        "loop_loads": where(lambda o: opclass(o) == "load" and not o.startswith("ULDC")),
        "loop_barriers": where(lambda o: opclass(o) == "barrier"),
        "loop_mufu": where(lambda o: o.startswith("MUFU")),
        "loop_calls": len(where(lambda o: o.startswith("CALL"))),
    }


def demangle(names):
    if not names or not shutil.which("c++filt"):
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    if len(out) != len(names):
        return names
    return [d.replace("(anonymous namespace)::", "").split("(")[0] for d in out]


def main():
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    with open(sys.argv[1]) as f:
        ks = kernels(f.read())
    names = [n for n in ks if all(p in n for p in sys.argv[2:])]
    for name, shown in zip(names, demangle(names)):
        print(json.dumps(describe(shown, ks[name])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
