"""Where the fused PsiFormer-layer kernel (``csrc/fl_block.cu``) spends its
time, and where its error comes from.

    python -m deepqmc_tpu_torch.ablate_fl_block [--errors-only]

At the H2O PsiFormer layer's shapes (B = 2048, K = 30, n = 10, d = 256,
4 heads; the preset's initialisation and the inputs from a seed):

Time.  Builds the kernel as it is and copies of it with one part taken out by
a source edit, and times each:

- ``no_wgmma``: no tensor-core product is issued;
- ``no_split``: the weights' stages are not split into the hi and lo tiles;
- ``no_weights``: no weight stage is copied from L2;
- ``no_attention``: the attention core of the directions (phase B) is skipped;
- ``skeleton``: all four at once (what is left: the epilogues, the sums over
  directions, the Jacobian's loads and stores, the barriers).

A variant's outputs are wrong by design; its time says what the part costs,
as the difference to the full kernel (the parts overlap, so the differences
do not add up).  Each line gives the median of 20 launches (CUDA events) and
the largest error against the plain version relative to max(1, |plain|).

Error.  The largest error of (y, J_y, L_y), relative to max(1, |reference|),
against the plain version in float64 on the card, of: the plain version in
float32; the kernel; the plain version with every d x d product in split TF32
(x = hi + lo, both rounded to TF32, lo*hi + hi*lo + hi*hi): as three products
summed on the CUDA cores in float32, as three products summed by cuBLAS on
the tensor cores, and as one sum over the three terms interleaved in steps of
8 inputs as the kernel issues them, on the CUDA cores and on the tensor
cores; and the plain version with one TF32 product on the tensor cores.  The
split's operands are exact in TF32, so the split readings differ only in how
the products are summed.  ``--errors-only`` skips the timings.

Needs a GPU and ``nvcc``.
"""

import argparse
import ctypes
import subprocess
from unittest import mock

import torch

from . import fwdlap, utils
from .gnn.update_features import NodeAttentionElectronUpdateFeature
from .ops import _cuda, fl_block

__all__ = ['main']

_WGMMA = ('  if constexpr (W == ', '  if constexpr (0 && W == ')
_SPLIT = ('        if (wt < W) {\n          const float* rs', '        if (0) {\n          const float* rs')
_WEIGHTS = ('        if (s < nk && has[u]) {', '        if (0) {')
_ATTENTION = (
    ('      // Jz_k = (Jq_k k^T', '      if (0) {\n      // Jz_k = (Jq_k k^T'),
    ('    // J_att = J + Jt Wo (in place in bufa)', '    }\n    // J_att = J + Jt Wo (in place in bufa)'),
)
VARIANTS = {
    'full': (),
    'no_wgmma': (_WGMMA,),
    'no_split': (_SPLIT,),
    'no_weights': (_WEIGHTS,),
    'no_attention': _ATTENTION,
    'skeleton': (_WGMMA, _SPLIT, _WEIGHTS, *_ATTENTION),
}


def _edit(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f'ablate_fl_block: the source no longer holds {old.strip()!r}')
        src = src.replace(old, new)
    return src


def _build(variants):
    """Compile every variant, all at once; {name: loaded library}."""
    out = _cuda.BUILD_DIR / 'ablate'
    out.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / 'fl_block.cu').read_text()
    procs = {}
    for name, edits in variants.items():
        (out / f'{name}.cu').write_text(_edit(src, edits))
        cmd = [_cuda.find_nvcc(), *_cuda.FLAGS, '-shared', str(out / f'{name}.cu'),
               '-o', str(out / f'{name}.so')]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=_cuda.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{log}')
        lib = ctypes.CDLL(str(out / f'{name}.so'))
        lib.fl_block_launch.argtypes, lib.fl_block_launch.restype = (
            _cuda._SIGNATURES['fl_block_launch'])
        libs[name] = lib
    return libs


def _tf32(x):
    """Round float32 to TF32 (10-bit mantissa), to nearest, as the kernel does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _steps(parts, dim):
    """Interleave the parts along ``dim`` in steps of 8 inputs: p0[0:8], p1[0:8],
    p2[0:8], p0[8:16], ... (the order of the kernel's three products a step)."""
    shape = parts[0].shape
    dim %= len(shape)
    head, d, tail = shape[:dim], shape[dim], shape[dim + 1:]
    blocks = [p.reshape(*head, d // 8, 8, *tail) for p in parts]
    return torch.stack(blocks, dim=dim + 1).reshape(*head, 3 * d, *tail)


def _tf32_matmul(form, tensor_cores):
    """``FL @ w`` (the six d x d products) with TF32 operands, summed by cuBLAS on
    the tensor cores or on the CUDA cores in float32.  ``form``: ``one``, hi*hi
    alone; ``split``, lo*hi + hi*lo + hi*hi with x = hi + lo as three products
    added at the end; ``chain``, the same three terms in one sum over 3 d inputs,
    interleaved as the kernel issues them."""

    def matmul(h, w):
        def mm(a):
            ah, wh = _tf32(a), _tf32(w)
            al, wl = _tf32(a - ah), _tf32(w - wh)
            torch.backends.cuda.matmul.allow_tf32 = tensor_cores
            try:
                if form == 'one':
                    return ah @ wh
                if form == 'chain':
                    return _steps((al, ah, ah), -1) @ _steps((wh, wl, wh), 0)
                return al @ wh + ah @ wl + ah @ wh
            finally:
                utils.set_true_fp32()

        return fwdlap.FL(mm(h.x), mm(h.jac), mm(h.lap))

    return matmul


def _rel_errors(got, ref):
    return [((g.double() - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
            for g, r in zip(got, ref)]


def errors(x, J, L, weights, H, kernel_out):
    """Print each version's largest errors against the float64 plain version."""
    plain = fl_block.psiformer_block_fl_plain
    ref = plain(*(t.double() for t in (x, J, L, *weights)), H)
    readings = {'plain float32': plain(x, J, L, *weights, H), 'kernel': kernel_out}
    for name, form, tensor_cores in (
        ('split TF32, three products, CUDA-core sums', 'split', False),
        ('split TF32, three products, tensor-core sums (cuBLAS)', 'split', True),
        ('split TF32, one CUDA-core sum in the kernel\'s order', 'chain', False),
        ('split TF32, one tensor-core sum in the kernel\'s order (cuBLAS)', 'chain', True),
        ('one TF32 product, tensor cores (cuBLAS)', 'one', True),
    ):
        with mock.patch.object(fwdlap.FL, '__matmul__', _tf32_matmul(form, tensor_cores)):
            readings[name] = plain(x, J, L, *weights, H)
    for name, got in readings.items():
        y, jy, ly = _rel_errors(got, ref)
        print(f'error of {name} against float64: y {y:.3e}, J_y {jy:.3e}, L_y {ly:.3e}',
              flush=True)
    y, jy, ly = _rel_errors(kernel_out, readings['plain float32'])
    print(f'error of kernel against plain float32: y {y:.3e}, J_y {jy:.3e}, L_y {ly:.3e}',
          flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(prog='python -m deepqmc_tpu_torch.ablate_fl_block')
    parser.add_argument('--errors-only', action='store_true', help='skip the timings')
    errors_only = parser.parse_args(argv).errors_only
    if not torch.cuda.is_available():
        raise SystemExit('ablate_fl_block: needs a GPU')
    utils.set_true_fp32()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=30)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed',
          flush=True)
    B, K, n, d, H = 2048, 30, 10, 256, 4
    gen = torch.Generator('cuda').manual_seed(0)
    x, J, L = (torch.randn(*s, generator=gen, device='cuda')
               for s in ((B, n, d), (B, K, n, d), (B, n, d)))
    layer = NodeAttentionElectronUpdateFeature.psiformer(
        d, num_heads=H, gen=torch.Generator().manual_seed(0)).cuda()
    weights = [w.detach() for w in layer.block_weights()]
    with torch.inference_mode():
        if not errors_only:
            _time_variants(x, J, L, weights, H)
        errors(x, J, L, weights, H, fl_block.psiformer_block_fl(x, J, L, *weights, H))


def _time_variants(x, J, L, weights, H):
    B, K, n, d = J.shape
    ref = fl_block.psiformer_block_fl_plain(x, J, L, *weights, H)
    kc = fl_block._pick_kc(K, n, d, H)
    outs = [torch.empty_like(t) for t in (x, J, L)]
    scratch = x.new_empty(B, fl_block.SCRATCH, n, d)
    ptrs = [t.data_ptr() for t in (x, J, L, *weights, outs[0], outs[1], outs[2], scratch)]
    for name, lib in _build(VARIANTS).items():
        def launch():
            code = lib.fl_block_launch(*ptrs, B, K, n, d, H, kc, _cuda.stream())
            _cuda.check(code, f'fl_block ({name})')

        ms = utils.cuda_median_ms(launch)
        rel = max(((o - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
                  for o, r in zip(outs, ref))
        print(f'{name}: {ms:.4f} ms, max rel err {rel:.3e}', flush=True)


if __name__ == '__main__':
    main()
