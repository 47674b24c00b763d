"""Count the machine instructions of a kernel's loops.

    python -m icek_torch.kernels._sass flash_attention fwd_mma_kernelILi4ELb0

builds ``csrc/<source>.cu`` as the wrappers do, disassembles the library
with the toolkit's ``cuobjdump -sass`` and prints, for every kernel whose
mangled name contains the given text, its instruction count and, for each
backward branch (a loop), the loop's static length and its most frequent
opcodes.  Where ``ncu`` is not to be had, this is the quickest way to see
what a kernel that is bound by its instruction count spends them on.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from icek_torch.kernels import _build

_INSTR = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")


def report(sass: str, name_part: str) -> list:
    """Lines of the report for the kernels of `sass` (cuobjdump's text) whose
    mangled name contains `name_part`."""
    out = []
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        if name_part not in name:
            continue
        instrs = [(int(a, 16), op, rest) for a, op, rest in _INSTR.findall(body)]
        out.append(f"{name.strip()}: {len(instrs)} instructions")
        for addr, op, rest in instrs:
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if target is None or int(target.group(1), 16) >= addr:
                continue
            start = int(target.group(1), 16)
            inside = [o.split(".")[0] for a, o, _ in instrs if start <= a <= addr]
            top = ", ".join(f"{o} {n}" for o, n in collections.Counter(inside).most_common(12))
            out.append(f"  loop {start:#x}..{addr:#x}: {len(inside)} instructions ({top})")
    return out


def loops(source: str, name_part: str) -> None:
    _build.load(source)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build._lib_path(source)],
                          capture_output=True, text=True, check=True).stdout
    print("\n".join(report(sass, name_part)))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    loops(sys.argv[1], sys.argv[2])
