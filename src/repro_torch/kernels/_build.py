"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``: seconds per file, where a build through
``torch.utils.cpp_extension`` (PyTorch's headers) takes minutes.  Builds
happen at first use on a CUDA tensor, never at import, and are cached in
``build/repro_torch_kernels/`` at the repository root under a hash of the
source, the shared headers and the flags, so an edited source rebuilds and
an unchanged one loads at once.  The compiler's register/shared-memory report
(``-Xptxas -v``) is kept beside each library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("encode_pack", "range_rerank", "leaf_bounds", "l2_rerank",
           "project_encode_pack", "lsh_project", "encode_bins",
           "flash_attention")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source on the machine with the GPU")
    return found


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the source checkout.

    The package must run from a checkout (``<root>/src/repro_torch``, with
    ``<root>/pyproject.toml``): an installed copy would write its libraries
    beside the interpreter's packages, shared by every checkout.
    """
    src = CSRC.parents[2]
    root = src.parent
    if src.name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(f"repro_torch's kernels build only from a source "
                           f"checkout (<root>/src/repro_torch); found the "
                           f"package under {src}")
    return root / "build" / "repro_torch_kernels"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built.  The hash
    covers the headers of ``csrc/`` too, which the sources include."""
    where = build_dir()
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return where / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees half a file


def build_all(names: tuple[str, ...] = KERNELS) -> None:
    """Compile every named source at once, one ``nvcc`` each, in parallel."""
    jobs = [job for job in map(_start, names) if job is not None]
    errors = []
    for job in jobs:                # wait for all, even after a failure
        try:
            _finish(job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))


def on_device(dev):
    """A context that makes CUDA device ``dev`` the current one, or none
    where it is current already (the switch costs more host time than a
    small launch)."""
    import torch
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({err(code).decode()})")
