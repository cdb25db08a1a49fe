"""ctypes bindings for the native batch-assembly core (npy_loader.cpp), the
port's copy of `bist_tpu.native.loader`, with a build at first use and a
numpy fallback.

The native path reads every feature .npy of a batch in a C++ thread pool and
streams the payloads straight into the final zero-padded (B, T_pad, S·D)
buffer: no interpreter lock, no intermediate arrays.  The library is built
with g++ the first time it is needed into build/bist_tpu_torch/
(`npyloader-<hash>.so`, the hash of the source and the flags, so an edited
source is rebuilt), never beside the source.  Where it cannot be built or
loaded (no g++), or a file is not a C-ordered float32 .npy, the numpy
fallback gives the same arrays; it logs once per process that it is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from bist_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "npy_loader.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
FALLBACK_LOG = "feature batches are assembled by the numpy fallback"

log = logging.getLogger(__name__)
_lib = None
_lock = threading.Lock()
_build_failed = False
_fallback_logged = False


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"npyloader-{digest}.so"


def _build() -> Optional[ctypes.CDLL]:
    """Compile the library if it is not built yet (to a temporary name,
    then renamed into place, so concurrent processes never load a partial
    file) and bind it; None when that fails."""
    global _build_failed
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError) as e:
            tmp.unlink(missing_ok=True)
            _build_failed = True
            _note_fallback(f"building {SRC.name} with g++ failed: {e}")
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        _build_failed = True
        _note_fallback(f"loading {so} failed: {e}")
        return None
    lib.npy_header_probe.restype = ctypes.c_int
    lib.npy_header_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.assemble_f32_batch.restype = ctypes.c_int
    lib.assemble_f32_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    return lib


def _note_fallback(why: str) -> None:
    global _fallback_logged
    if not _fallback_logged:
        _fallback_logged = True
        log.warning("%s (%s)", FALLBACK_LOG, why)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def probe_npy_shape(path: str) -> Tuple[int, ...]:
    """The array shape from a .npy file's header (no payload read)."""
    lib = _get_lib()
    if lib is not None:
        shape = (ctypes.c_int64 * 8)()
        ndim = lib.npy_header_probe(path.encode(), shape)
        if ndim > 0:
            return tuple(int(shape[i]) for i in range(ndim))
    return tuple(np.load(path, mmap_mode="r", allow_pickle=True).shape)


def assemble_feature_batch(paths: Sequence[str], t_pad: int,
                           tail_shape: Tuple[int, ...], n_threads: int = 8,
                           out: Optional[np.ndarray] = None) -> np.ndarray:
    """Read float32 .npy files of shape (T_i, *tail_shape) into a zero-padded
    (len(paths), t_pad, *tail_shape) batch.  Files longer than t_pad are
    truncated (data/batching.pad_features' semantics).  `out`, a C-ordered
    float32 array of that shape (e.g. in pinned memory), receives the batch
    in place of a new array."""
    row_elems = int(np.prod(tail_shape))
    shape = (len(paths), t_pad) + tuple(tail_shape)
    if out is None:
        out = np.empty(shape, np.float32)
    elif out.shape != shape or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-ordered float32 array of shape {shape}; got "
                         f"{out.dtype} {out.shape}")
    lib = _get_lib()
    if lib is not None:
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        rc = lib.assemble_f32_batch(
            arr, len(paths), t_pad, row_elems,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
        if rc == 0:
            return out
        _note_fallback(f"{paths[-rc - 1]} is not a C-ordered float32 .npy of "
                       f"rows of {row_elems}")
    for i, p in enumerate(paths):
        f = np.load(p, allow_pickle=True)
        f = f.reshape((f.shape[0], -1)).astype(np.float32, copy=False)
        rows = min(f.shape[0], t_pad)
        flat = out[i].reshape(t_pad, row_elems)
        flat[:rows] = f[:rows, :row_elems]
        flat[rows:] = 0.0
    return out
