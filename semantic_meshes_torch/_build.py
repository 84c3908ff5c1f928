"""Build and load the port's CUDA kernels and its host IO library.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library with
a plain C interface, `build/torch_kernels/lib<name>-<hash>.so` at the root
of the checkout, the first time it is needed, together with the further
sources SOURCES names for it (`raster_dense` also holds the dense
preparation of `csrc/dense_prep.cu`, and `raster_tile` the tile
preparation of `csrc/tile_prep.cu`, so each route runs one build);
the hash covers the sources, the shared headers `csrc/*.cuh` and the
flags, so an edited source or header rebuilds. nvcc's output (with the
-Xptxas -v register and shared-memory report) is kept beside it as `.log`.
Each host source `csrc/<name>.cpp` (the `.sens` / images.bin IO library,
see `native.py`) is compiled the same way by g++, with threads (no
OpenMP) and zlib (`build_host`). Every library is written to a temporary
file and renamed into place, so processes that build at once never load
a partial one. The libraries are loaded with ctypes. A failed build
raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# every source of a library, where it is more than csrc/<name>.cu
SOURCES = {"raster_dense": ("raster_dense.cu", "dense_prep.cu"),
           "raster_tile": ("raster_tile.cu", "tile_prep.cu")}

CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-pthread", "-Wall", "-shared")
CXX_LIBS = ("-lz",)

_loaded = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "semantic_meshes_torch are built from source at first use"
    )


def sources(name):
    """The CUDA sources of library `name`."""
    return [CSRC / src for src in SOURCES.get(name, (f"{name}.cu",))]


def library_path(name):
    """The library of csrc/<name>.cu; its hash covers its sources, every
    csrc/*.cuh header (a kernel may include any of them) and the flags."""
    h = hashlib.sha256()
    for src in sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names):
    """Compile the sources of each library not built yet: one nvcc process
    per library, all started together. Returns the libraries' paths."""
    outs = [library_path(name) for name in names]
    todo = [(name, out) for name, out in zip(names, outs) if not out.exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(src) for src in sources(name))]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in running:
        log = proc.communicate()[0]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return outs


def build_log(name):
    """nvcc's output (with the -Xptxas -v register and shared-memory
    report) from the build of `name`, or '' if it was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name):
    """The ctypes library of kernel `name`, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)[0]))
    return _loaded[name]


def host_library_path(name):
    """The library of csrc/<name>.cpp; its hash covers that source and
    the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(name):
    """Compile csrc/<name>.cpp with g++ unless it is built already. Returns
    the library's path; raises RuntimeError with g++'s output on failure."""
    out = host_library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found on PATH: the host IO library of "
            "semantic_meshes_torch is built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{out.name}.", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(CSRC / f"{name}.cpp"), *CXX_LIBS]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"host library build failed: {name} (g++ exit "
                f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_host(name):
    """The ctypes library of host source `name`, built first if needed."""
    key = ("host", name)
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(str(build_host(name)))
    return _loaded[key]
