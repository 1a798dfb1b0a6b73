"""Build the port's CUDA kernels from source and load them with ``ctypes``.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` goes into one shared
library with a plain C interface (no PyTorch headers, so ``nvcc`` takes
seconds, not minutes).  Each source compiles in its own ``nvcc`` process,
all started together, then one link step.  The library's file name carries
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the earlier build.  Output goes to
``build/repro_torch_kernels/`` at the repository root.

Nothing here runs at import: the first wrapper call on a CUDA tensor builds
and loads.  A failed build raises — there is no fallback.

C convention: pointers and the stream are ``void*`` (``ctypes.c_void_p``),
sizes ``int``; every entry point returns ``cudaGetLastError()`` after its
launch, and :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[pathlib.Path]:
    """Every kernel source (``*.cu``) in the package, sorted."""
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(KERNELS_DIR.glob("**/csrc/*.cu*")):      # .cu and .cuh
        h.update(p.relative_to(KERNELS_DIR).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_source_hash()}.so"


def build() -> pathlib.Path:
    """Compile (if the hashed library is missing) and return its path.
    The compiler's per-kernel register / shared-memory report lands in
    ``build.log`` beside the library."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.relative_to(KERNELS_DIR)} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = pathlib.Path(tmp) / lib.name
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
                               *[str(o) for _, o, _ in procs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def function(name: str, argtypes: tuple):
    """A C entry point of the library with its argument types declared
    (``c_void_p`` for every pointer and the stream, so none is cut to 32
    bits) and an ``int`` (the CUDA error code) as its result."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
