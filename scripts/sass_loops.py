"""Count the SASS instructions of a kernel's loops in the built library.

    python3 scripts/sass_loops.py NAME [NAME ...]

Needs the CUDA toolkit's ``cuobjdump``; builds the kernels first
(``repro_torch.kernels.build.library``).  For each kernel whose mangled
name contains NAME, prints its instruction count and, for its three
largest loops (the code between a backward branch and its target), the
instructions, the ``MUFU.EX2`` among them and the opcode counts, so that
a loop's instructions can be set beside the work it does.
"""
from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(names) -> int:
    from repro_torch.kernels import build
    build.library()
    so = next(build.BUILD_DIR.glob("librepro_torch_kernels-*.so"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(so)],
                         capture_output=True, text=True, check=True).stdout
    for want in names:
        sec = next((part for part in out.split("Function : ")[1:]
                    if want in part.splitlines()[0]), None)
        if sec is None:
            print(f"{want}: not found")
            continue
        ins = []
        for line in sec.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)([^;]*);", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
        print(f"{want}: {len(ins)} instructions")
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                lo = int(t.group(1), 16)
                loops.append([x for x in ins if lo <= x[0] <= addr])
        for body in sorted(loops, key=len, reverse=True)[:3]:
            ops = collections.Counter(o.split(".")[0] for _, o, _ in body)
            ex2 = sum(1 for _, o, _ in body if o.startswith("MUFU.EX2"))
            print(f"  loop of {len(body)}, {ex2} MUFU.EX2: "
                  f"{ops.most_common(30)}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
