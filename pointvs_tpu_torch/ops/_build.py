"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries go to
``ops/build/`` (listed in .gitignore), named by a digest of the source and
the flags, so an edited source is rebuilt and never served stale. Nothing
is built at import time: the first kernel launch builds what it needs, and
``build_all`` builds every source at once, one nvcc process per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).parent / 'csrc'
BUILD_DIR = Path(__file__).parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signature of every exported function, by library.
SIGNATURES = {
    'segment_kernels': {
        # data, offsets, out, k, num_segments, stream
        'pvs_segment_sum_sorted': (_P, _P, _P, _I, _I, _P),
        # feat, logits, trans, mask, offsets, out, seg_max, k,
        # num_segments, softmax, stream
        'pvs_softmax_aggregate_sorted': (_P,) * 7 + (_I, _I, _I, _P),
        # variant index, int[5] as pvs_fused_forward_info's
        'pvs_segment_kernel_info': (_I, _P),
    },
    'fused_egnn': {
        # h, h_dst, extras, mask, senders, prev, 9 weights, agg, phi, att,
        # msg, num_edges, k, num_nodes, attention, tanh, stream
        'pvs_fused_edge_forward': (_P,) * 19 + (_I64, _I, _I, _I, _I, _P),
        # int[5]: registers, spill bytes, static and dynamic shared bytes,
        # blocks resident per SM
        'pvs_fused_forward_info': (_P,),
    },
    'fused_egnn_bwd': {
        # h, h_dst, extras, mask, senders, prev, 9 weights, d_agg, d_phi,
        # d_att, d_msg, d_h_src, d_h_dst, d_radial, d_prev, scratch,
        # partials, d_params, num_edges, k, num_nodes, attention, tanh,
        # stream
        'pvs_fused_edge_backward': (_P,) * 26 + (_I64, _I, _I, _I, _I, _P),
        'pvs_fused_backward_param_width': (),
        'pvs_fused_backward_num_blocks': (_I,),
        # int[5]: registers, spill bytes, static and dynamic shared bytes,
        # blocks resident per SM
        'pvs_fused_backward_info': (_P,),
    },
}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise RuntimeError('nvcc not found: put the CUDA toolkit on PATH or '
                       'set CUDA_HOME')


def library_path(name: str) -> Path:
    # The digest covers the shared headers too, so editing one rebuilds.
    sources = [SRC_DIR / f'{name}.cu'] + sorted(SRC_DIR.glob('*.cuh'))
    digest = hashlib.sha256(
        b''.join(src.read_bytes() for src in sources)
        + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet.

    All nvcc processes start together and are waited on; a failed build
    raises with the compiler's output. Returns wall seconds per library
    built (0.0 for one already present). The compiler's report (registers,
    spills per kernel, from ``-Xptxas -v``) is kept in ``<library>.log``.
    """
    names = sorted(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(SRC_DIR / f'{name}.cu')]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, start) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        out.with_suffix('.log').write_text(log)
        if proc.returncode != 0:
            failures.append(f'{name}.cu (nvcc exit {proc.returncode}):\n'
                            f'{log}')
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError('CUDA kernel build failed:\n' +
                           '\n'.join(failures))
    return seconds


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The named library, built first if needed, with argtypes set."""
    path = library_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


KERNEL_INFO_KEYS = ('registers', 'spill_bytes', 'static_smem_bytes',
                    'dynamic_smem_bytes', 'blocks_per_sm')


def read_kernel_info(library: str, function: str, *args) -> dict:
    """A kernel's resources on the current CUDA device (builds it if
    needed): registers per thread, spill bytes per thread, shared bytes per
    block and the blocks resident per SM at those. ``args`` come before
    the info array (a variant's index)."""
    info = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = getattr(load(library), function)(*args, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f'{function} failed: cudaError {err}')
    return dict(zip(KERNEL_INFO_KEYS, info))
