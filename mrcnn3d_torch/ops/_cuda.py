"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled with nvcc
for Hopper (`sm_90a`) into `mrcnn3d_torch/_build/lib<name>-<hash>.so`,
where the hash covers the source and the flags, and loaded with ctypes.
Nothing is built at import: the first launch builds what it needs, and
`build()` builds every kernel at once, one nvcc process per source, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# each kernel's own flags.  nms3d: -fmad=false, no multiply-add
# contraction, so every product and sum of the IoU rounds as in the plain
# PyTorch version and a comparison at the threshold decides the same way.
# roi_align3d contracts its interpolation sums; its sample coordinates are
# explicit round-to-nearest intrinsics, which are never contracted.
KERNEL_FLAGS = {"nms3d": ("-fmad=false",), "roi_align3d": ()}
KERNELS = tuple(KERNEL_FLAGS)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + KERNEL_FLAGS[name]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(_flags(name)).encode()
    digest = hashlib.sha256(src + flags).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile the named kernels that are not built yet, in parallel.

    Returns {name: {"seconds": wall time, "ptxas": compiler report}};
    a kernel already built reports 0 seconds and no report.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": text}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream
