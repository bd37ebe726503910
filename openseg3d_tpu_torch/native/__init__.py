"""The C++ host voxelizer, built with g++ at first use and loaded with ctypes.

A copy of ``openseg3d_tpu/native`` (the JAX package's production input path:
its ``VoxelGenerator`` takes it whenever it builds). ``voxelizer.cpp`` is that
package's source with one fix on the ``max_voxels`` path, which no caller
takes (see the file), so both packages give the same bits on one host:
the kernel is ``floor((p - min) * (1 / voxel_size))`` in float32, with no
multiply-add that ``-march=native`` could contract, so another x86 host gives
the same ids too. It multiplies by the reciprocal where the numpy path
(``core/voxelizer.points_to_voxel``) divides, so a point on a voxel boundary
can land one voxel apart from the numpy path.

Unlike the original, the library is built into ``openseg3d_tpu_torch/_build/``
(never beside the source), under a name that hashes the source and the flags,
with the compiler's output kept beside it as ``.log``; and the fallback is not
silent: when g++ fails, one WARNING names the compiler's error, and
``available()`` says which path ``VoxelGenerator`` takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'voxelizer.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
CXX = 'g++'
CXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC')

_lock = threading.Lock()
_lib = None
_error: str | None = None
logger = logging.getLogger(__name__)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(' '.join((CXX,) + CXX_FLAGS).encode())
    return BUILD_DIR / f'libvoxelizer-{digest.hexdigest()[:16]}.so'


def _build(out: Path) -> None:
    """Compile the source into `out`; raises RuntimeError with the
    compiler's output when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [CXX, *CXX_FLAGS, '-o', str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f'{" ".join(cmd)}: {e}') from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'{" ".join(cmd)} failed ({proc.returncode}): {log.strip()}')
    out.with_suffix('.log').write_text(log)
    os.replace(tmp, out)        # atomic: a concurrent loader never sees half a file


def get_lib():
    """The loaded library, built first if needed; None (after one WARNING
    naming the error) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError) as e:
            _error = ' '.join(str(e).split())
            logger.warning('C++ voxelizer unavailable, using the numpy path: %s', _error)
            return None
        lib.voxelize.restype = ctypes.c_int32
        lib.voxelize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.majority_labels.restype = None
        lib.majority_labels.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ voxelizer builds and loads on this host."""
    return get_lib() is not None


def build_error() -> str | None:
    """The compiler's or loader's error when the library is unavailable."""
    get_lib()
    return _error


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f'the C++ voxelizer is unavailable: {_error}')
    return lib


def native_points_to_voxel(points: np.ndarray, voxel_size, coors_range,
                           max_voxels: int | None = None):
    """C++ voxelization, the contract of ``core.voxelizer.points_to_voxel``:
    (coords [M, 3] int32 zyx in ascending key order, point_voxel_ids [N]
    int32, -1 out of range or past max_voxels)."""
    lib = _require()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    vs = np.ascontiguousarray(voxel_size, dtype=np.float32)
    rg = np.ascontiguousarray(coors_range, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3 or vs.shape != (3,) or rg.shape != (6,):
        raise ValueError(f'points [N, >=3], voxel_size [3], range [6]; got {pts.shape}, '
                         f'{vs.shape}, {rg.shape}')
    gs = np.round((rg[3:] - rg[:3]) / vs).astype(np.int64)
    n = pts.shape[0]
    cap = int(max_voxels) if max_voxels else n
    ids = np.empty(n, np.int32)
    coords = np.empty((cap, 3), np.int32)
    m = lib.voxelize(_fptr(pts), n, pts.shape[1], _fptr(vs), _fptr(rg),
                     int(gs[0]), int(gs[1]), int(gs[2]),
                     _iptr(ids), _iptr(coords), cap)
    return coords[:m].copy(), ids


def native_majority_labels(point_voxel_ids, point_labels, num_voxels,
                           ignore_index=255):
    """C++ majority vote, the contract of
    ``core.voxelizer.majority_voxel_labels``."""
    lib = _require()
    ids = np.ascontiguousarray(point_voxel_ids, dtype=np.int32).reshape(-1)
    labels = np.ascontiguousarray(point_labels, dtype=np.int64).reshape(-1)
    if ids.shape != labels.shape:
        raise ValueError(f'{ids.shape[0]} voxel ids for {labels.shape[0]} labels')
    out = np.full(num_voxels, ignore_index, np.int32)
    lib.majority_labels(_iptr(ids),
                        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        ids.shape[0], num_voxels, ignore_index, _iptr(out))
    return out
