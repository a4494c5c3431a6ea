"""Device time of a callable on the card, with CUDA events.

The one timing helper of the port's kernel measurements: ``chip_smoke.py``,
the kernel sweep (``rpnet_tpu_torch.bench_tools.corr_sweep``) and
``tools/corr_ab.py`` all time with :func:`cuda_ms`.
"""

from __future__ import annotations


def cuda_ms(fn, reps: int, warmup: int = 2, rounds: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls back to back between
    two CUDA events, so the queue stays full and the host's launch time is
    hidden wherever the device is the slower side (a single timed call would
    count the device idling while the host enqueues); the median of
    ``rounds`` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]
