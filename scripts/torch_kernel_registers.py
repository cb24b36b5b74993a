#!/usr/bin/env python3
"""Registers, stack frame and spills of every kernel instance of the torch
port, as ptxas reports them, on a machine with nvcc:

    python3 scripts/torch_kernel_registers.py

Compiles each source under ``sphfluidsimulation_torch/csrc`` with the port's
nvcc flags (``ops/cuda_build.py``), once with no switch and once with each
tuning variant's switches that the source reads (``cuda_build.defines``),
adding ``-Xptxas -v``, and prints one line per kernel instance: the source,
the switches, the kernel and its template arguments (for K1-K3 ``<kExt,
kBand>`` or ``<kBand>``, for K5 ``<mode, kExt, kBand>``), its registers and
its stack frame, spill store and spill load bytes.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sphfluidsimulation_torch.ops import cuda_build  # noqa: E402
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning  # noqa: E402

VARIANTS = (SortedTuning(fuse_acc=False), SortedTuning(kahan=True),
            SortedTuning(bf16=True))
_ENTRY = re.compile(r"Compiling entry function '\w*?(density_kernel|"
                    r"fused_substep_kernel|forces_kernel|compact_kernel)"
                    r"I(\w*?)EE")
_USED = re.compile(r"Used (\d+) registers")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")


def report(source: str, switches: tuple[str, ...]) -> list[str]:
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [cuda_build.nvcc_path(), *flags, *switches, "-Xptxas", "-v",
               "-c", "-o", f"{tmp}/k.o", str(cuda_build.CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stderr}")
    lines, name = [], None
    for line in proc.stderr.splitlines():
        if m := _ENTRY.search(line):
            args = ",".join(re.findall(r"L[bi](\d+)E", m.group(2) + "E"))
            name = f"{m.group(1)}<{args}>"
            frame = None
        elif (f := _FRAME.search(line)) and name:
            frame = f.groups()
        elif (u := _USED.search(line)) and name:
            stack, st, ld = frame or ("?", "?", "?")
            lines.append(f"{source} {' '.join(switches) or '(default)'} "
                         f"{name}: {u.group(1)} registers, stack {stack} B, "
                         f"spill stores {st} B, spill loads {ld} B")
            name = None
    return lines


def main() -> None:
    for source in cuda_build.KERNELS:
        sets = [()] + [cuda_build.defines(source, t) for t in VARIANTS]
        for switches in dict.fromkeys(sets):
            print("\n".join(report(source, switches)), flush=True)


if __name__ == "__main__":
    main()
