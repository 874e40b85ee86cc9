"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``ops/kernels/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes``: no PyTorch header is compiled, so a cold build takes seconds,
not the minutes a ``torch.utils.cpp_extension`` build of the same code
takes.  All sources compile in parallel, one ``nvcc`` process each, at
first use, into ``ratis_tpu_torch/_build/`` (git-ignored); a library is
named by a hash of its source and flags, so an edit rebuilds it and an
unchanged source is reused (the shared headers, ``kernels/*.cuh``, are part
of every source's hash).

Nothing here runs at import: this module is imported on machines with no
CUDA toolkit (the CPU tests), where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

KERNEL_DIR = pathlib.Path(__file__).resolve().parent / "kernels"
BUILD_DIR = KERNEL_DIR.parents[1] / "_build"
SOURCES = ("resident_step.cu", "tally_votes.cu", "ledger_pass.cu",
           "vote_lease.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-source nvcc wall seconds and ptxas report of the builds this process
# ran (empty when every library was already built)
build_seconds: dict[str, float] = {}
build_reports: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in ((os.path.join(CUDA_HOME, "bin", "nvcc")
                  if CUDA_HOME else None), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def _target(source: str) -> pathlib.Path:
    h = hashlib.sha256((KERNEL_DIR / source).read_bytes())
    # the shared headers too: an edit there rebuilds every source
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, all in parallel
    (seconds and ptxas reports land in ``build_seconds`` /
    ``build_reports``).  Raises with the compiler's output when any build
    fails."""
    with _lock:
        todo = [s for s in SOURCES if not _target(s).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.monotonic()
        for s in todo:
            tmp = _target(s).with_suffix(f".{os.getpid()}.tmp")
            procs[s] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for s, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_seconds[s] = time.monotonic() - t0
            build_reports[s] = out
            if proc.returncode != 0:
                failed.append(f"{s}:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _target(s))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _lib(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(source)))
        lib.k_error_string.restype = ctypes.c_char_p
        lib.k_error_string.argtypes = [ctypes.c_int]
        _libs[source] = lib
    return lib


# ctypes argument codes used by Kernel signatures
PTR, INT, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def c_function(source: str, symbol: str, argtypes: tuple, restype=INT):
    """A C function of a kernel library with its types set (the library
    is built at first use)."""
    fn = getattr(_lib(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def raise_on_error(source: str, symbol: str, err: int) -> None:
    if err != 0:
        msg = _lib(source).k_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA launch failed: {msg}")


class Kernel:
    """One C launcher of a kernel source.  Calling it launches on the
    current stream of the tensors' device, raises on a launch error, and
    counts the launch in ``launches`` — the count a run reads to show that
    its path went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: tuple):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            self._fn = c_function(self.source, self.symbol,
                                  (*self.argtypes, PTR))
        return self._fn

    def __call__(self, device, *args) -> None:
        import torch
        fn = self._load()
        if device.index == torch.cuda.current_device():
            # the common case: no device switch
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
        raise_on_error(self.source, self.symbol, err)
        self.launches += 1
