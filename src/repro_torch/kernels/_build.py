"""Build and load this package's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C entry point; the
``csrc/*.cuh`` headers hold device functions they share.  A kernel is
compiled on first use, from the sources in the checkout, into
``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists), where the hash covers the source, the
shared headers and the compiler flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  ``build`` starts one ``nvcc`` per
missing library, all together, and waits for them.  A missing ``nvcc``, a failed build or a
failed launch raises; nothing here falls back to another path.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its probes
and its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
KERNELS = ("sorted_probe", "run_probe", "delta_probe", "eqrange_owned",
           "fingerprint_rows", "replay_delta", "flash_attention",
           "flash_attention_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Kernel launches by name since the counts were last set to 0.
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else the toolkit's own
    (``$CUDA_HOME/bin/nvcc``, default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built, keyed by a hash of
    its source, the shared headers and the compiler flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> float:
    """Compile every named kernel whose library is missing — one ``nvcc``
    per source, all started together — and return the seconds it took.
    Raises with the compiler's output when any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = library_path(name)
        # a private temporary name, renamed into place when complete, so
        # concurrent builds never load a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode(errors='replace')})")
