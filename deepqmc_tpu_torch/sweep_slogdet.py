"""Time both bodies of the log-determinant trace kernels (``csrc/fl_slogdet.cu``)
on one GPU, from 10 to 48 electrons, and hold each to its plain version.

    python3 -m deepqmc_tpu_torch.sweep_slogdet

For each layout (flat: kernel 2, ``slogdet_traces``; square: kernel 3,
``square_traces``; square split: kernel 4, ``square_split_traces``) and each
n, rows split at ceil(n / 2), it prints the staged and the tiled body's median
time a wrapper call (CUDA events, 5 calls after one, host time included) and
their time a launch with 20 launches back to back between two events (the
device's time, the host's hidden behind it), their largest error against the
plain version relative to max(1, max |plain|), and the body the library picks
by n (``fl_slogdet_body``).  n = 10 runs the main path's shapes (B = 2048,
D = 16, K = 30); the others B = 256, D = 16, K = 3 n (chip_smoke.py's n = 42
shape).  These times set the library's ``kFlatMaxN`` and ``kSquareMaxN``.  The
card's name and power limit come first.
"""

import subprocess
import sys

import torch

from .ops import _cuda
from .ops import fl_slogdet as fs
from .utils import cuda_median_ms, set_true_fp32

SIZES = (10, 12, 14, 16, 18, 20, 24, 28, 32, 33, 36, 40, 42, 48)


def _operands(gen, B, K, D, nu, nd):
    n = nu + nd
    a = torch.eye(n, device='cuda') + 0.3 / n**0.5 * torch.randn(B, D, n, n, generator=gen,
                                                                 device='cuda')
    inv = torch.linalg.inv(a).contiguous()
    ja = torch.randn(B, K, D, n, n, generator=gen, device='cuda')
    la = torch.randn(B, D, n, n, generator=gen, device='cuda')

    def flat(j):  # [B, K, D, rows, n] -> [B, K, rows, D*n]
        return j.movedim(2, 3).flatten(-2).contiguous()

    return {
        'flat': (fs.FLAT, fs.slogdet_traces, fs.slogdet_traces_plain,
                 (inv, flat(ja[..., :nu, :]), flat(ja[..., nu:, :]))),
        'square': (fs.SQUARE, fs.square_traces, fs.square_traces_plain, (inv, ja, la)),
        'square_split': (fs.SQUARE_SPLIT, fs.square_split_traces, fs.square_split_traces_plain,
                         (inv, ja[..., :nu, :].contiguous(), ja[..., nu:, :].contiguous(), la)),
    }


def back_to_back_ms(fn, reps=20):
    """ms a call of ``fn`` over ``reps`` calls between two CUDA events, after one."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _rel_err(got, ref):
    return max(((g - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
               for g, r in zip(got, ref))


def main():
    if not torch.cuda.is_available():
        sys.exit('sweep_slogdet: CUDA is not available; this script needs a GPU')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=30, check=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    set_true_fp32()
    lib = _cuda.library()
    gen = torch.Generator('cuda').manual_seed(0)
    for n in SIZES:
        nu = -(-n // 2)
        B, D, K = (2048, 16, 30) if n == 10 else (256, 16, 3 * n)
        for name, (layout, kernel, plain, args) in _operands(gen, B, K, D, nu, n - nu).items():
            ref = plain(*args)
            line = []
            for body in (fs.STAGED, fs.TILED):
                if body == fs.STAGED and n > fs.STAGED_MAX_N:
                    continue
                err = _rel_err(kernel(*args, body=body), ref)
                if not err <= 1e-4:  # chip_smoke.py's KERNEL_RTOL
                    sys.exit(f'sweep_slogdet: the {("staged", "tiled")[body]} body of {name} '
                             f'disagrees with its plain version at n={n} (rel err {err:.2e})')
                ms = cuda_median_ms(lambda: kernel(*args, body=body), runs=5, warmup=1)
                b2b = back_to_back_ms(lambda: kernel(*args, body=body))
                line.append(f'{("staged", "tiled")[body]} {ms:.4f} ms, {b2b:.4f} back to back '
                            f'(G={kernel.last_plan.G}, S={kernel.last_plan.S}, rel err {err:.2e})')
            auto = ('staged', 'tiled')[lib.fl_slogdet_body(layout, n)]
            print(f'{name} n={n} B={B} D={D} K={K}: ' + ', '.join(line)
                  + f'; the library takes the {auto} body', flush=True)
            del ref
        del args
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
