"""Helpers shared by the port's entry points."""

import torch

__all__ = ['cuda_median_ms', 'resolve_device']


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    ``None`` means ``cuda``; where CUDA is absent that raises instead of
    falling back to the CPU, so a caller who wants the CPU says so.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def set_true_fp32():
    """Full-precision float32 products on the card: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cuda_median_ms(fn, runs=20, warmup=3):
    """Median time of ``fn()`` on the card in ms, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]
