"""Compare the machine code (SASS) of the kernels two builds share.

    python -m mrcnn3d_torch.tools.sass_diff OLD.so NEW.so

Each argument is a shared library that nvcc built from a kernel source
(`mrcnn3d_torch/_build/lib<name>-<hash>.so`, or an older source built
with the flags of `ops/_cuda.py`).  For each kernel function both hold,
it prints whether the instructions are equal, equal once registers are
renumbered by first use, and how many instruction lines differ.  Names
are matched with the anonymous namespace's file tag dropped; branch
labels are renumbered per function (ptxas numbers them across the
file).  Needs `cuobjdump` (the CUDA toolkit: the machine with the card).
"""
from __future__ import annotations

import argparse
import re
import subprocess


def functions(path):
    """{kernel name: [instruction lines]} of a library's SASS."""
    out = subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON",
                          m.group(1))
            funcs[name] = []
        elif name and (re.match(r"\s*/\*[0-9a-f]{4}\*/", line)
                       or re.match(r"\s*\.L_x_\d+:", line)):
            funcs[name].append(re.sub(r"\s+", " ", line.strip()))
    for name, lines in funcs.items():
        labels = {}
        for ln in lines:
            for lab in re.findall(r"\.L_x_\d+", ln):
                labels.setdefault(lab, f".L{len(labels)}")
        funcs[name] = [re.sub(r"\.L_x_\d+", lambda m: labels[m.group(0)], ln)
                       for ln in lines]
    return funcs


def renamed(lines):
    """The instructions without their encodings, registers renumbered by
    first use."""
    regs = {}
    out = []
    for ln in lines:
        ln = re.sub(r";\s*/\*.*?\*/\s*$", ";", ln)
        out.append(re.sub(r"\bR\d+\b", lambda m: regs.setdefault(
            m.group(0), f"r{len(regs)}"), ln))
    return out


def compare(old, new):
    """One line per kernel both libraries hold."""
    a, b = functions(old), functions(new)
    rows = []
    for name in sorted(set(a) & set(b)):
        differ = sum(x != y for x, y in zip(a[name], b[name])) + abs(
            len(a[name]) - len(b[name]))
        rows.append(f"{name}: {len(a[name])} / {len(b[name])} lines, "
                    f"{differ} differ, equal: {a[name] == b[name]}, equal "
                    f"up to registers: {renamed(a[name]) == renamed(b[name])}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old")
    p.add_argument("new")
    args = p.parse_args(argv)
    for row in compare(args.old, args.new):
        print(row)


if __name__ == "__main__":
    main()
