"""Episode prefetching for the eval CLI: the ``num_workers`` threads.

The counterpart of ``rpnet_tpu/episode/prefetch.py``. With the device
volume cache off (``device_volume_cache: 0``) and ``num_workers > 0`` the
CLI assembles upcoming episodes in a thread pool while the device runs the
current one; NRRD decoding and numpy release the GIL.

The support picks are drawn (or taken from ``picks``, drawn before the
loop) on the caller's thread, in episode order, so the stdlib ``random``
stream is consumed exactly as by a serial loop; the workers draw nothing.
"""

from __future__ import annotations

import queue
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterator

from rpnet_tpu_torch.episode.sampler import Episode, EpisodeSampler


class EpisodeFailure:
    """Yielded in place of an episode whose assembly raised.

    Raising from the generator would close it, and every later episode would
    be lost with the one bad volume; the caller re-raises ``exc`` for the
    one episode instead.
    """

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchingSampler:
    """Iterate episodes ``lookahead`` ahead, assembled by ``workers`` threads.

    >>> for ep in PrefetchingSampler(sampler, lookahead=2, workers=4):
    ...     runner.run(ep)
    """

    def __init__(self, sampler: EpisodeSampler, lookahead: int = 2,
                 workers: int = 2, indices=None, picks=None):
        """Iterates the episodes ``indices`` of ``sampler`` in that order
        (default: all; a process of a multi-process eval passes its shard).
        ``picks``: episode id → support picks drawn beforehand. Without it
        the picks are drawn on the caller's thread at submit time."""
        self.sampler = sampler
        self.lookahead = max(1, lookahead)
        self.workers = max(1, workers)
        self.indices = list(range(len(sampler))) if indices is None else list(indices)
        self.picks = picks

    def __iter__(self) -> Iterator[Episode]:
        n = len(self.indices)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending: "queue.Queue[Future]" = queue.Queue()

            def submit(pos: int):
                idx = self.indices[pos]
                picks = (list(self.picks[idx]) if self.picks is not None
                         else self.sampler.draw_supports(idx))
                pending.put(pool.submit(self.sampler.sample, idx, picks))

            upto = min(self.lookahead, n)
            for i in range(upto):
                submit(i)
            for _ in range(n):
                fut = pending.get()
                if upto < n:
                    submit(upto)
                    upto += 1
                try:
                    ep = fut.result()
                except Exception as e:   # noqa: BLE001 — one episode, not the stream
                    ep = EpisodeFailure(e)
                yield ep
