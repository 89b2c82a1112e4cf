"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel library is one ``csrc/<name>.cu`` with a plain C interface
(it may include headers of ``csrc/`` with ``#include "..."``), compiled
for ``sm_90a`` into a shared library under ``kernels/build/`` (listed in
``.gitignore``) at first use. The library's file name carries a digest
of its source, the headers it includes and the flags, so an edited
source or header is rebuilt and never shadowed by a stale library, and
an edit to one library's header rebuilds only the libraries that
include it. A user kernel registered with ``utils.custom_op.cuda_op``
is built the same way from its source text (written beside its library
as ``<name>-<digest>.cu``). Nothing is built when a module is imported:
CPU-only machines import every module and never call here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "library_path",
           "source_paths", "load_source"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("ragged_attention", "ragged_attention_int8",
           "ragged_attention_fp8", "ragged_attention_int8_f16",
           "ragged_attention_int8_bf16", "ragged_attention_fp8_f16",
           "ragged_attention_fp8_bf16", "int8_matmul", "flash_fwd_f32",
           "flash_fwd_bf16", "flash_bwd_bf16", "flash_fwd_f16",
           "flash_bwd_f16", "flash_bwd_f32", "paged_attention",
           "mixed_attention", "dropout")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card, at first use")
    return path


def _local_headers(path: Path, seen=None) -> list:
    """The ``csrc/`` headers ``path`` includes with ``#include "..."``,
    directly or through another such header, in first-include order."""
    seen = [] if seen is None else seen
    for name in re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(),
                           flags=re.M):
        header = CSRC / name
        if header not in seen:
            seen.append(header)
            _local_headers(header, seen)
    return seen


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    src = source.read_bytes()
    src += b"".join(h.read_bytes() for h in _local_headers(source))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def source_paths(name: str, text: str) -> Tuple[Path, Path]:
    """Where the library built from CUDA source ``text`` lives: the
    source and the library, both named by ``name`` and a digest of the
    text and the flags."""
    digest = hashlib.sha256(
        (text + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    stem = BUILD_DIR / f"{name}-{digest}"
    return stem.with_suffix(".cu"), stem.with_suffix(".so")


def build(names: Iterable[str] = KERNELS,
          sources: Optional[Dict[str, str]] = None
          ) -> Dict[str, Tuple[str, float]]:
    """Compile every named kernel of ``csrc/`` and every ``sources``
    entry (library name -> CUDA source text) not built yet, one
    ``nvcc`` per source, all started together. Returns, for each
    compiled library, its compiler log (``-Xptxas -v``: registers,
    shared memory, spills) and the seconds from the common start until
    its ``nvcc`` exited; raises with the log when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: (CSRC / f"{name}.cu", library_path(name))
               for name in names}
    for name, text in (sources or {}).items():
        src, out = source_paths(name, text)
        if not out.exists():
            tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
        targets[name] = (src, out)
    jobs = {}
    t0 = time.perf_counter()
    for name, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    done: Dict[str, Tuple[str, float]] = {}
    failed = []
    pending = dict(jobs)
    while pending:
        for name, (proc, tmp, out) in list(pending.items()):
            try:
                log, _ = proc.communicate(timeout=0.05)
            except subprocess.TimeoutExpired:
                continue
            del pending[name]
            if proc.returncode:
                failed.append(f"nvcc failed for {name}:\n{log}")
                continue
            os.replace(tmp, out)
            done[name] = (log, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The compiled kernel library ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def load_source(name: str, text: str) -> ctypes.CDLL:
    """The library built from CUDA source ``text``, built first if
    needed."""
    build((), {name: text})
    return ctypes.CDLL(str(source_paths(name, text)[1]))
