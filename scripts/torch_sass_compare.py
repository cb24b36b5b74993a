#!/usr/bin/env python3
"""Compare the machine code of two source trees' kernels, function by
function, on a machine with nvcc:

    python3 scripts/torch_sass_compare.py ROOT_A ROOT_B [--out FILE]

Builds, in each tree, the kernel libraries of the port (every source of
``ops/cuda_build.KERNELS``, once with no switch and once with each tuning
variant's switches that the source reads), each into that tree's own
``build/``, dumps each library with ``cuobjdump -sass`` and compares the
SASS text of every kernel function that both trees build. A kernel's
mangled name carries a hash of its source file in the part of the name
that the anonymous namespace gives it; that part is normalised before
names are matched. The parameter offsets are part of the text, so a
parameter added before another moves that function's code.

Prints one line per library, then one JSON line. No kernel runs, so no
card is needed, only nvcc and its ``cuobjdump``. ``--out`` writes the
differing functions' two SASS texts to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# the anonymous namespace's part of a mangled name: a length, then
# _GLOBAL__N__<hash>_<len>_<file>_cu_<hash>
_ANON = re.compile(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}")
_BUILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from sphfluidsimulation_torch.ops import cuda_build
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
tunes = (SortedTuning(fuse_acc=False), SortedTuning(kahan=True),
         SortedTuning(bf16=True))
paths = cuda_build.build(tunes)
jobs = [(s, ()) for s in cuda_build.KERNELS]
for t in tunes:
    jobs += [(s, cuda_build.defines(s, t)) for s in cuda_build.KERNELS
             if cuda_build.defines(s, t)
             and (s, cuda_build.defines(s, t)) not in jobs]
print(json.dumps({f"{s} {' '.join(d) or '(default)'}": str(
    cuda_build.library_path(s, d)) for s, d in jobs}))
"""


def libraries(root: str) -> dict[str, str]:
    """{"source switches": library path} of ``root``'s built libraries."""
    out = subprocess.run([sys.executable, "-c", _BUILD, root], check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def functions(lib: str) -> dict[str, str]:
    """{normalised kernel name: its SASS text} of one library."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in dump.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        body = "\n".join(re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)",
                                    block))
        out[_ANON.sub(r"ANON_\1", name)] = body
    return out


def _nvcc() -> str:
    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..")))
    from sphfluidsimulation_torch.ops import cuda_build
    return cuda_build.nvcc_path()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out")
    args = ap.parse_args()
    la, lb = libraries(os.path.abspath(args.a)), libraries(
        os.path.abspath(args.b))
    same, differ, only = [], [], []
    dumps = []
    for key in sorted(la.keys() | lb.keys()):
        if key not in la or key not in lb:
            only.append(key)
            continue
        fa, fb = functions(la[key]), functions(lb[key])
        d = sorted(n for n in fa.keys() & fb.keys() if fa[n] != fb[n])
        s = sorted(n for n in fa.keys() & fb.keys() if fa[n] == fb[n])
        o = sorted(fa.keys() ^ fb.keys())
        same += [f"{key}: {n}" for n in s]
        differ += [f"{key}: {n}" for n in d]
        only += [f"{key}: {n} (only in {'a' if n in fa else 'b'})"
                 for n in o]
        dumps += [f"== {key}: {n}\n-- a\n{fa[n]}\n-- b\n{fb[n]}\n" for n in d]
        print(f"{key}: {len(s)} functions identical, {len(d)} differ, "
              f"{len(o)} in one tree only", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("".join(dumps))
    print(json.dumps({"a": args.a, "b": args.b, "identical": len(same),
                      "differ": differ, "only": only}), flush=True)


if __name__ == "__main__":
    main()
