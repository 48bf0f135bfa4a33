#!/usr/bin/env python3
"""Registers and spills of flash_star's bf16 kernel at head_dim 256 for two
KV tile sizes: the reason ``mk_of(256)`` in ``flash_star.cu`` is 32.

Compiles ``src/repro_torch/kernels/flash_star/csrc/flash_star.cu`` twice
with the repository's nvcc flags, once with 64-row and once with 32-row KV
tiles at D > 128, and prints ptxas's lines for every
``flash_star_mma_kernel`` instantiation.  Needs ``nvcc`` (a machine with
the CUDA toolkit); run from the root of a checkout:

    python3 tools/flash_star_tiles.py
"""

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels.flash_star import kernel as fk  # noqa: E402

LINE = "constexpr int mk_of(int d) { return d > 128 ? 32 : 64; }"


def main() -> int:
    src = fk.SOURCE.read_text()
    if LINE not in src:
        print(f"{fk.SOURCE}: the tile rule {LINE!r} is not there", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for mk in (64, 32):  # both compiles at once
            cu = Path(tmp) / f"flash_star_{mk}.cu"
            cu.write_text(src.replace(LINE, LINE.replace("? 32", f"? {mk}")))
            runs[mk] = subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(Path(tmp) / f"lib{mk}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for mk, proc in runs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                print(log[-4000:], file=sys.stderr)
                return proc.returncode
            print(f"KV tile of {mk} rows at D > 128:")
            func = None
            for line in log.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    func = m.group(1) if "flash_star_mma_kernel" in m.group(1) else None
                elif func and ("spill" in line or "Used" in line):
                    tag = re.search(r"ILi(\d+)ELb([01])E", func)
                    print(f"  D={tag.group(1)} {'star' if tag.group(2) == '1' else 'exact'}: "
                          f"{line.replace('ptxas info    :', '').strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
