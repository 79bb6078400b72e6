"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and include no PyTorch header.  Each
unit (a source, or a part of one: ``fl_slogdet.cu`` is built in two, its
float and its bf16 kernels) is compiled by its own ``nvcc`` process, all
started together, and the
objects are linked into one shared library named after a hash of the sources
and flags, under ``deepqmc_tpu_torch/_build/`` (listed in ``.gitignore``), so a
stale library is never loaded.  The library is loaded with ``ctypes``; every
pointer and the stream are passed as ``c_void_p`` and every size as ``c_int``.
Several processes on one machine (the ranks of a data-parallel run) build
once: the first takes a file lock on the build directory and links into a
temporary name that it renames into place, the others wait on the lock and
load what it built.

Nothing here runs at import: the first kernel launch builds and loads.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import forward_ad

__all__ = ['build', 'library', 'check', 'stream']

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
SOURCES = ('fl_attention.cu', 'fl_slogdet.cu', 'fl_block.cu')
# (source, its own nvcc flags): one compile each, all in parallel
UNITS = (
    ('fl_attention.cu', ()),
    ('fl_slogdet.cu', ('-DFL_SLOGDET_PART=0',)),
    ('fl_slogdet.cu', ('-DFL_SLOGDET_PART=1',)),
    ('fl_block.cu', ()),
)
FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-Xcompiler', '-fPIC',
)
BUILD_TIMEOUT_S = 300

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    'fl_attention_launch': ([_P] * 12 + [_I] * 8 + [_P], _I),
    'fl_attention_smem_bytes': ([_I] * 4, _L),
    'fl_slogdet_traces_launch': ([_P] * 5 + [_I] * 9 + [_P] * 2, _I),
    'fl_slogdet_square_launch': ([_P] * 5 + [_I] * 8 + [_P] * 2, _I),
    'fl_slogdet_square_split_launch': ([_P] * 6 + [_I] * 9 + [_P] * 2, _I),
    'fl_slogdet_body': ([_I] * 2, _I),
    'fl_slogdet_smem_bytes': ([_I] * 4 + [_L, _I], _L),
    'fl_block_launch': ([_P] * 15 + [_I] * 6 + [_P], _I),
    'fl_block_smem_bytes': ([_I] * 4, _L),
}

_lib = None


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which('nvcc')
    if found:
        return found
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        'nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin; '
        'the CUDA kernels cannot be built'
    )


def _digest() -> str:
    h = hashlib.sha256(' '.join(FLAGS).encode())
    h.update(repr(UNITS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f'libdeepqmc_kernels_{_digest()}.so'


def build(verbose: bool = False) -> Path:
    """Compile the sources in parallel and link them into one library.

    Returns the library's path; does nothing when it already exists.  A failed
    or timed-out compile raises with the compiler's output.  Holds a lock on
    the build directory while it builds, so concurrent callers build once.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():  # built by another process while this one waited
            _compile_and_link(nvcc, out, verbose)
    return out


def _compile_and_link(nvcc: str, out: Path, verbose: bool):
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        extra = ('-Xptxas', '-v') if verbose else ()
        for i, (name, unit_flags) in enumerate(UNITS):
            obj = Path(tmp) / f'{Path(name).stem}_{i}.o'
            cmd = [nvcc, *FLAGS, *unit_flags, *extra, '-c', str(CSRC / name), '-o', str(obj)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objs.append(str(obj))
        deadline = time.monotonic() + BUILD_TIMEOUT_S
        failures, logs = [], []
        for name, proc in procs:
            try:
                log, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for _, other in procs:
                    other.kill()
                    other.communicate()
                raise RuntimeError(f'nvcc timed out after {BUILD_TIMEOUT_S} s on {name}')
            logs.append(f'--- {name}\n{log}')
            if proc.returncode != 0:
                failures.append(name)
        if failures:
            raise RuntimeError('nvcc failed on ' + ', '.join(failures) + '\n' + '\n'.join(logs))
        if verbose:
            print('\n'.join(logs), flush=True)
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, '-shared', *objs, '-o', str(tmp_lib)],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}{link.stderr}')
        os.replace(tmp_lib, out)


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _lib = lib
    return _lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def refuse_tangents(name: str, *tensors):
    """Raise if an operand carries a forward-mode tangent (``torch.autograd.
    forward_ad`` or ``torch.func.jvp``): a kernel launched on its data pointer
    would return a result without the tangent, silently."""
    for t in tensors:
        if t is not None and forward_ad.unpack_dual(t).tangent is not None:
            raise RuntimeError(
                f'{name}: an operand carries a forward-mode tangent, which the CUDA kernel '
                'cannot propagate; run the forward Laplacian with plain_cores=True '
                '(fwdlap.use_plain_cores) for a tangent pass'
            )


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f'{name}: CUDA error {code} at launch')


def smem_limit() -> int:
    """Opt-in shared memory per block of the current card, in bytes."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return int(getattr(props, 'shared_memory_per_block_optin', 227 * 1024))
