"""Build and load the hand-written CUDA kernels (``apex_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. Nothing
includes PyTorch's headers, so a build takes seconds. Libraries land in
``build/apex_tpu_torch/`` at the root of the checkout, named by a hash
of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Several sources build in parallel, one ``nvcc``
each. A failed build raises with the compiler's output; nothing falls
back.

Nothing here runs at import time: a CPU-only process imports this module
without ``nvcc`` and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["SOURCES", "build", "load", "lib_path"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"

#: the kernel sources, by library name (``csrc/<name>.cu``)
SOURCES = ("layer_norm", "paged_attention", "flash_attention", "xentropy",
           "multi_tensor")

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of apex_tpu_torch build on a machine with the CUDA "
        "toolkit")


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by a hash of every
    source and header in ``csrc/`` plus the compiler flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        if p.suffix == ".cuh" or p.stem == name:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Returns ``{name:
    (seconds, compiler output)}`` for the sources it compiled (``-Xptxas
    -v`` output: registers, shared memory, spills). Raises with the
    compiler's output when any build fails."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        src = _CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no kernel source {src}")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_FLAGS, "-o", tmp, str(src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    results, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) "
                          f"---\n{out}")
            Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, lib_path(name))       # atomic: no half-written .so
        results[name] = (dt, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first when
    needed. Callers declare ``argtypes``/``restype`` on what they use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib
