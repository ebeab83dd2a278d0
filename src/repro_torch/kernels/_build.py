"""Builds the port's CUDA kernels and loads them with ctypes.

Every ``*.cu`` under ``src/repro_torch/csrc`` is compiled for Hopper
(``sm_90a``) by its own ``nvcc`` process, all started together, and the
objects are linked into one shared library with a plain C interface.  The
library is named after a hash of the sources and flags, so an edited
kernel rebuilds and an unchanged one loads at once.  The build goes to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``)
unless ``REPRO_TORCH_BUILD_DIR`` names another directory; ``ptxas``'s
per-kernel register and shared-memory report is kept beside it in
``build.log``.

Nothing here runs at import: :func:`lib` builds on first use, on a machine
with ``nvcc``, and raises if there is none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every exported launcher: (argtypes, restype)
SIGNATURES = {
    "rt_gemm": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    "rt_flash_attention": (
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I),
    "rt_fused_mlp": (
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "rt_fused_mlp_smem_bytes": ((_I,), _I),
    "rt_fused_mlp_blocks_per_sm": ((_I, _I), _I),
}

_LIB: list[ctypes.CDLL] = []


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the shared library's path."""
    out = build_dir()
    lib_path = out / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.is_file():
        return lib_path
    out.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = []
    for src in sources():
        obj = out / f"{src.stem}_{os.getpid()}.o"
        cmd = [cc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name} (exit {p.returncode})\n{text}")
        if p.returncode:
            failed.append(src.name)
    (out / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out / f"{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [cc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if not _LIB:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _LIB.append(handle)
    return _LIB[0]


def check(rc: int, what: str) -> None:
    """Raise on a launcher's non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
