"""Build and load the port's CUDA kernels.

Each `bist_tpu_torch/csrc/<name>.cu` has a plain C interface and is compiled
by `nvcc` into its own shared library, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/bist_tpu_torch/<name>-<hash>.so csrc/<name>.cu

`BUILD_DIR` is `build/bist_tpu_torch/` of the source tree when the package
runs from one (a checkout: `pyproject.toml` and `chip_smoke.py` beside the
package), and otherwise, installed from a wheel, a per-user cache
directory: `$XDG_CACHE_HOME/bist_tpu_torch` (default
`~/.cache/bist_tpu_torch`), never inside site-packages.

The library name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an unchanged
one is loaded as built.  `build()` starts
one `nvcc` per missing library, all at once, and raises if any fails.
Nothing here runs at import: the kernels' libraries are built the first
time a wrapper launches a kernel (or when a caller asks, as `chip_smoke.py`
does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    tree = Path(__file__).resolve().parents[2]
    if (tree / "pyproject.toml").is_file() and (tree / "chip_smoke.py").is_file():
        return tree / "build" / "bist_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "bist_tpu_torch"


BUILD_DIR = _build_dir()
KERNEL_SOURCES = ("hop1_fwd", "hop1_bwd", "flash_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and $PATH): the port's CUDA "
                           "kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None,
          ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    `nvcc` each, all started together.  Returns {name: {"seconds", "log"}}
    for each library compiled by this call; raises RuntimeError naming the
    failed sources with their compiler output."""
    names = list(names) if names is not None else list(KERNEL_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    results, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built first if needed,
    together with every other kernel source not built yet, all in parallel:
    a process that launches one kernel (a train step's K1) soon launches
    another (its K2), and one build after the other would add up inside
    that first step."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
