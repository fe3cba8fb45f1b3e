"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` under the
checkout; the hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Building never happens at import:
the first launch on a CUDA tensor builds (or :func:`build_all` does it
ahead of time, all sources at once).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) per
#: kernel built by this process
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` or the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels are built at first use")


def source(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    return src


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: pathlib.Path, nvcc: str = "nvcc") -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source(name))]


def build_all(names: Iterable[str] = KERNELS) -> dict[str, float]:
    """Compile every named kernel that is not built yet: one ``nvcc`` per
    source, all started together.  Returns the wall seconds of each build
    (0.0 for a library already on disk).  Raises with nvcc's output if any
    build fails, after every started compiler has exited."""
    seconds: dict[str, float] = {}
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(name, tmp, nvcc_path()),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)        # atomic: a reader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load_file(path: str, stem: str) -> ctypes.CDLL:
    """Build a CUDA source outside ``csrc/`` (another version of a kernel,
    for timing against it) with the same flags into
    ``build/kernels/lib<stem>-<hash>.so``, and load it."""
    src = pathlib.Path(path).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(path)],
                       check=True)
    return ctypes.CDLL(str(out))


def load(name: str,
         declare: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``declare`` sets the C functions' ``argtypes``/``restype`` once, when
    the library is first loaded in this process."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        if declare is not None:
            declare(lib)
        _LIBS[name] = lib
    return lib
