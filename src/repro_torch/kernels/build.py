"""Build CUDA sources into shared libraries with a plain C interface.

nvcc compiles each library for ``sm_90a`` (Hopper) at first use, into
``build/repro_torch/`` at the repository root, named by a hash of its
sources and flags so that an edited source is rebuilt.  A library is
loaded with ``ctypes``; nothing here includes PyTorch's headers, which
keeps a build to seconds.  The shared device headers
(``kernels/csrc/*.cuh``) enter every library's hash.  ``build_libraries``
starts one nvcc per library, all at once, and waits for them together.
Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
HEADERS = sorted((Path(__file__).resolve().parent / "csrc").glob("*.cuh"))
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    seconds: float                      # build (or load) time
    built: bool                         # False: found in the build dir
    ptxas: List[str] = field(default_factory=list)  # register/spill/wgmma lines


_LOADED: Dict[str, Library] = {}


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *HEADERS]:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(specs: Mapping[str, Sequence[Path]]) -> Dict[str, Library]:
    """Compile each ``name -> sources`` into lib<name>-<hash>.so once per
    process, running the nvcc processes side by side."""
    started = {}
    for name, sources in specs.items():
        if name in _LOADED:
            continue
        out = _target(name, sources)
        proc = tmp = None
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        started[name] = (out, tmp, proc, time.perf_counter())
    errors = []
    for name, (out, tmp, proc, t0) in started.items():
        log = out.with_suffix(".log")
        if proc is not None:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name} ({proc.returncode}):\n"
                              f"{' '.join(proc.args)}\n{stdout}{stderr}")
                continue
            log.write_text(stdout + stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        ptxas = [line.strip() for line in
                 (log.read_text().splitlines() if log.exists() else [])
                 if "entry function" in line or "registers" in line
                 or "spill" in line or "wgmma" in line]
        _LOADED[name] = Library(lib, out, time.perf_counter() - t0,
                                proc is not None, ptxas)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _LOADED[name] for name in specs}


def build_library(name: str, sources: Sequence[Path]) -> Library:
    """Compile ``sources`` into lib<name>-<hash>.so once per process."""
    return build_libraries({name: sources})[name]
