"""Build the package's CUDA source with nvcc and load it with ctypes.

`csrc/<name>.cu` compiles, at first use, into a shared library with a
plain C interface under `_build/` (listed in `.gitignore`), named by a hash
of its source, the `csrc/*.cuh` headers and the flags (preprocessor
`defines` included), so an edited source or header rebuilds.

Only the card's machine runs this: nothing here is called when a module
is imported, and the CPU paths never need it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a: Hopper with its arch-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Compile `csrc/<name>.cu` unless already built; return the library path.

    `defines` are macros set for this build (`-D<macro>`): a library built
    with them is a separate file. The compiler's output (ptxas register
    and shared-memory report) is kept beside the library as `<lib>.log`.
    Raises if nvcc fails.
    """
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out.with_suffix(".log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stdout.decode(errors='replace')}"
        )
    os.replace(tmp, out)
    return out


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` built with `defines`, building it if needed."""
    key = (name, defines)
    if key not in _libs:
        _libs[key] = ctypes.CDLL(str(build(name, defines)))
    return _libs[key]
