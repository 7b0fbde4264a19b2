"""The one CUDA-event timer of the port's measurements (``chip_smoke.py`` and
the ``profile_*`` scripts time every kernel with it)."""

from __future__ import annotations

import statistics

import torch

__all__ = ["time_cuda"]

# Written before every run: five times the H100's 50 MB L2, so ``fn`` finds
# it cold, as a caller between sweeps does.
FLUSH_BYTES = 256 << 20


def time_cuda(fn, reps: int = 15, spin_cycles: int = 2_000_000) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each after a write of
    ``FLUSH_BYTES`` that evicts the L2 and a spin of ``spin_cycles`` (~1 ms)
    on the card, which keeps the card busy while the host prepares the
    launch: the time is the card's, not the wrapper's host overhead. With
    ``spin_cycles=0`` the host's time in the wrapper falls inside the window
    wherever it outlasts the flush."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)
