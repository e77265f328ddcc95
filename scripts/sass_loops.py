#!/usr/bin/env python3
"""Count the instructions of each loop of a kernel in `cuobjdump -sass` output.

    python3 scripts/sass_loops.py FILE.sass [--kernel SUBSTRING] [--min 50]

For every function whose mangled name contains SUBSTRING, prints its
instruction count and, for each loop (a branch back to an earlier address,
so the body is the range from its target to the branch), the body's
instructions in all and on the multi-function unit (MUFU: ex2, lg2, rcp,
rsq, sin, cos, tanh), as one JSON line each; loops with fewer than --min
instructions are left out.  A loop's count includes the loops nested in it.
NOPs (the padding after the last EXIT) are not counted.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

FUNC = re.compile(r"^\s*Function : (\S+)")
INST = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH = re.compile(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")


def parse(path):
    funcs, cur = {}, None
    for line in open(path):
        m = FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = INST.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def loops(insts, min_len):
    out = []
    for addr, text in insts:
        m = BRANCH.search(text)
        if not (m and m.group(1)):
            continue
        target = int(m.group(1), 16)
        if target > addr:
            continue
        body = [t for a, t in insts if target <= a <= addr and not t.startswith("NOP")]
        if len(body) >= min_len:
            out.append({"start": hex(target), "end": hex(addr), "instructions": len(body),
                        "mufu": sum("MUFU" in t for t in body),
                        "mufu_ops": sorted({t.split()[0].split(".", 1)[-1] if "MUFU" in
                                            t.split()[0] else t.split()[1].split(".", 1)[-1]
                                            for t in body if "MUFU" in t})})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sass")
    ap.add_argument("--kernel", default="")
    ap.add_argument("--min", type=int, default=50)
    a = ap.parse_args()
    for name, insts in parse(a.sass).items():
        if a.kernel not in name:
            continue
        body = [t for _, t in insts if not t.startswith("NOP")]
        print(json.dumps({"function": name, "instructions": len(body),
                          "mufu": sum("MUFU" in t for t in body)}))
        for lp in loops(insts, a.min):
            print(json.dumps({"function": name, **lp}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
