"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` into its own shared library under ``build/repro_torch_kernels/``
at the repository root, then loaded with ``ctypes``.  Nothing includes
PyTorch's headers, so a build takes seconds.  Libraries are named by a
hash of their source, the local headers it includes (``#include "..."``,
followed transitively) and the flags: an unchanged kernel is never
rebuilt in the same checkout, and an edited one, or one whose shared
header was edited, never loads a stale library.

Every C entry point launches on the stream it is given, returns
``cudaGetLastError()``, and the Python wrapper raises on a non-zero code
(a refused launch never runs and a later synchronise would not say so).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("huffman_decode", "paged_attention", "paged_mla_attention",
           "binarize_pack", "binary_contraction", "fused_decode_contraction")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels of repro_torch are built on the machine "
                       "with the card")


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes, transitively."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together -> {name: seconds} of the builds run.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        procs[name] = (time.monotonic(), target, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for name, (t0, target, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v`` register/shared-memory report)
    of the last build of ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code:
        msg = getattr(lib, f"{prefix}_error_string")
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {code} "
                           f"({msg(code).decode()})")
