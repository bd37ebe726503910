"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with nvcc for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` at first use and
loaded with ctypes. The hash covers the source, every ``csrc/*.cuh`` header
and the flags, so an edited source or header is rebuilt and a stale library
is never loaded. A failed build raises
with nvcc's output. ``build_all`` compiles several sources at once, one nvcc
process each. Nothing is compiled or loaded when the package is imported:
CPU-only hosts never come here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
KERNELS = ('window_attention', 'window_attention_train', 'nearest_point', 'sparse_conv')

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    for cand in (os.path.join(home, 'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit')


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in (CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))):
        digest.update(src.name.encode() + b'\0' + src.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build_all(names=KERNELS) -> dict[str, tuple[Path, float, str]]:
    """Compile csrc/<name>.cu for every name whose library is not built yet,
    all nvcc processes started together. Returns {name: (library path, build
    seconds, compiler output)}, the output of an earlier build (kept beside
    its library) and 0 seconds where the library was built already; raises if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix('.log')
            results[name] = (out, 0.0, log.read_text() if log.exists() else '')
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, tmp, out)
    failed = []
    for name, (proc, cmd, tmp, out) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n{log}')
            continue
        out.with_suffix('.log').write_text(log)
        os.replace(tmp, out)    # atomic: a concurrent loader never sees half a file
        results[name] = (out, seconds, log)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return results


def build(name: str) -> tuple[Path, float, str]:
    """Compile csrc/<name>.cu unless its library is built already.
    Returns (library path, build seconds, compiler output)."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _, _ = build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
