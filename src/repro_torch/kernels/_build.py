"""Build the kernels' CUDA sources into shared libraries and load them.

Every kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
with ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the
repository root (the hash covers the source and the flags, so an edit
rebuilds) and loaded with ``ctypes``.  Nothing is built when a module is
imported: ``load`` builds at first use, and ``build_all`` builds every
kernel at once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
#: kernel name -> its CUDA source
SOURCES = {
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "paged_attention": _PKG / "paged_attention" / "csrc" / "paged_attention.cu",
    "mlstm_scan": _PKG / "mlstm_scan" / "csrc" / "mlstm_scan.cu",
    "dequant": _PKG / "dequant" / "csrc" / "dequant.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


#: build output, at the repository root (listed in .gitignore)
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temporary output, library path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({SOURCES[name]}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names=None) -> dict[str, str]:
    """Build the named kernels (default: all) in parallel; returns each
    one's compiler output (empty when it was already built)."""
    names = list(names or SOURCES)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
