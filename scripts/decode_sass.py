#!/usr/bin/env python3
"""Compare the SASS of one instantiation of the fused decode kernel (B2)
across checkouts of the port, on the GPU host.

    python3 scripts/decode_sass.py --src A/src --src B/src [--per 9]
        [--d 1] [--dtype f64] [--split 0] [--grid 0]

Builds each checkout's kernels (``repro_torch.kernels.build.build_all``,
in a subprocess a checkout, all at once), dumps the SASS of the
``decode_fused_kernel<T, PER, DM[, SPLIT[, GRID]]>`` instantiation (GRID
false unless ``--grid 1``, which implies SPLIT)
from its library with ``cuobjdump -sass``, and prints one JSON line: for
each checkout its instruction count and count by opcode; for each pair
the instructions that differ once addresses, encodings and constant-bank
offsets (the kernel parameters' places) are taken out — as built, and
with registers, predicates and immediates renamed away — by opcode, and
the first differing lines.  The default is the ``mean`` route's unsplit
instantiation at 525 float64 lanes, W = 2 (9 lanes a thread, D = 1).
"""
import argparse
import difflib
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path


def build(src: Path) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; build.build_all()")
    return subprocess.Popen([sys.executable, "-c", code, str(src)])


def library(src: Path) -> Path:
    libs = sorted((src.parent / "build" / "repro_torch_kernels").glob(
        "decode_fused-*.so"), key=lambda p: p.stat().st_mtime)
    if not libs:
        sys.exit(f"decode_sass: no decode_fused library under {src.parent}")
    return libs[-1]


def functions(so: Path) -> dict:
    """{mangled name: [SASS lines]} of every function in ``so``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[name].append(line)
    return funcs


def normalise(line: str) -> str:
    """An instruction without its address, encoding and constant-bank
    offsets."""
    line = re.sub(r"/\*\s*[0-9a-fx]+\s*\*/", "", line)
    line = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", line)
    return " ".join(line.replace(";", "").split())


def renamed(line: str) -> str:
    """The instruction with its registers, predicates and branch targets
    taken out: what differs once register allocation is set aside."""
    line = re.sub(r"\bU?R\d+\b", "R", line)
    line = re.sub(r"\bU?P\d\b", "P", line)
    return re.sub(r"0x[0-9a-f]+", "0x", line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--per", type=int, default=9)
    ap.add_argument("--d", type=int, default=1,
                    help="DM: 1 or 8 (0: the wide family)")
    ap.add_argument("--dtype", choices=("f64", "f32"), default="f64")
    ap.add_argument("--split", type=int, default=0)
    ap.add_argument("--grid", type=int, default=0)
    args = ap.parse_args()
    srcs = [Path(s).resolve() for s in args.src]
    for proc in [build(s) for s in srcs]:
        if proc.wait() != 0:
            sys.exit("decode_sass: a build failed")
    t = "d" if args.dtype == "f64" else "f"
    # Checkouts before the split have no SPLIT argument, before the grid
    # no GRID argument (false wherever present).
    b = ("Lb1ELb1E" if args.grid else "Lb1E(Lb0E)?" if args.split
         else "(Lb0E){0,2}")
    pat = re.compile(rf"decode_fused_kernelI{t}Li{args.per}ELi{args.d}E"
                     rf"{b}EEv")
    out, code = {"instantiation": pat.pattern, "checkouts": {}}, {}
    for src in srcs:
        funcs = functions(library(src))
        names = [n for n in funcs if pat.search(n)]
        if len(names) != 1:
            sys.exit(f"decode_sass: {len(names)} functions match in {src}")
        lines = [normalise(x) for x in funcs[names[0]]]
        code[str(src)] = lines
        ops = Counter(x.split()[1 if x.startswith("@") else 0].split(".")[0]
                      for x in lines if len(x.split()) > 1
                      or not x.startswith("@"))
        out["checkouts"][str(src)] = {"function": names[0],
                                      "instructions": len(lines),
                                      "by_opcode": dict(ops.most_common())}
    pairs = {}
    keys = list(code)
    for i, a in enumerate(keys):
        for b_ in keys[i + 1:]:
            pair = {}
            for how, f in (("as_built", str), ("registers_renamed",
                                                renamed)):
                diff = [d for d in difflib.unified_diff(
                    [f(x) for x in code[a]], [f(x) for x in code[b_]],
                    lineterm="", n=0)
                    if d[:1] in "+-" and d[:3] not in ("+++", "---")]
                pair[how] = {"differing_lines": len(diff),
                             "opcodes": dict(Counter(
                                 d[0] + d[1:].split()[
                                     1 if d[1:].startswith("@") else 0]
                                 for d in diff if d[1:].split())),
                             "first": diff[:40]}
            pairs[f"{a} vs {b_}"] = pair
    out["pairs"] = pairs
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
