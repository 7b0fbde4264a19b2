"""Token data pipeline: synthetic corpus + memmap shard reader with
background prefetch and deterministic, restart-safe iteration order.

The port of ``repro.data.pipeline``. The streams are NumPy, as in the
reference, and give the same batches bit for bit for the same seed;
``models.model.loss_fn`` moves a batch to the parameters' device. One
addition: ``Prefetcher.close()`` (and ``with Prefetcher(...)``) stops and
joins its thread.

* ``SyntheticLM`` — endless next-token batches from a seeded generator with
  mild Zipfian token statistics (keeps loss curves non-degenerate for the
  examples without shipping a corpus).
* ``MemmapDataset`` — flat uint32 token shards (``shard_*.bin``) read as
  rolling windows; an epoch-scoped RNG permutes window order so a restart
  at (epoch, index) reproduces the exact stream — checkpointable data
  state = 2 ints, the property that matters for fault tolerance.
* ``Prefetcher`` — N-deep background thread so host batch assembly overlaps
  device compute; ``close()`` stops and joins it.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Any, Iterator

import numpy as np

__all__ = ["SyntheticLM", "MemmapDataset", "Prefetcher", "write_corpus"]


class SyntheticLM:
    """Deterministic synthetic LM batches: {tokens, labels} int32 arrays."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed

    def batch_at(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        # Zipf-ish marginal + local repetition structure learnable by an LM.
        base = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        tokens = (base % (self.vocab_size - 2)) + 1
        # inject copy structure: every 16th position repeats 8 back
        tokens[:, 16::16] = tokens[:, 8:-8:16][:, : tokens[:, 16::16].shape[1]]
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def write_corpus(path: str | Path, n_tokens: int, vocab_size: int, seed: int = 0,
                 shard_tokens: int = 1 << 20) -> list[Path]:
    """Write a synthetic corpus as uint32 memmap shards (for the examples)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    written = 0
    shard = 0
    while written < n_tokens:
        n = min(shard_tokens, n_tokens - written)
        arr = (rng.zipf(1.3, size=n) % (vocab_size - 2) + 1).astype(np.uint32)
        p = path / f"shard_{shard:05d}.bin"
        arr.tofile(p)
        out.append(p)
        written += n
        shard += 1
    return out


class MemmapDataset:
    """Rolling windows over uint32 token shards, deterministic shuffle.

    State = (epoch, index); ``state()``/``seek()`` make it checkpointable.
    """

    def __init__(self, path: str | Path, seq_len: int, batch: int, seed: int = 0):
        self.paths = sorted(Path(path).glob("shard_*.bin"))
        if not self.paths:
            raise FileNotFoundError(f"no shard_*.bin under {path}")
        self.maps = [np.memmap(p, dtype=np.uint32, mode="r") for p in self.paths]
        self.total = sum(m.shape[0] for m in self.maps)
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.n_windows = self.total // (seq_len + 1)
        self.epoch = 0
        self.index = 0
        self._flat_starts = np.cumsum([0] + [m.shape[0] for m in self.maps])

    def state(self) -> dict:
        return {"epoch": self.epoch, "index": self.index}

    def seek(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.index = int(state["index"])

    def _window(self, w: int) -> np.ndarray:
        start = w * (self.seq_len + 1)
        shard = int(np.searchsorted(self._flat_starts, start, "right") - 1)
        off = start - self._flat_starts[shard]
        need = self.seq_len + 1
        chunks = []
        while need > 0:
            m = self.maps[shard]
            take = min(need, m.shape[0] - off)
            chunks.append(np.asarray(m[off : off + take]))
            need -= take
            shard = (shard + 1) % len(self.maps)
            off = 0
        return np.concatenate(chunks)

    def next_batch(self) -> dict[str, np.ndarray]:
        perm_rng = np.random.default_rng((self.seed, self.epoch))
        perm = perm_rng.permutation(self.n_windows)
        toks = []
        for _ in range(self.batch):
            if self.index >= self.n_windows:
                self.epoch += 1
                self.index = 0
                perm_rng = np.random.default_rng((self.seed, self.epoch))
                perm = perm_rng.permutation(self.n_windows)
            toks.append(self._window(int(perm[self.index])))
            self.index += 1
        arr = np.stack(toks).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        while True:
            yield self.next_batch()


class Prefetcher:
    """Background prefetch of an iterator, depth-bounded. ``close()``, or
    leaving a ``with`` block, stops the thread and joins it."""

    _SENTINEL = object()
    _POLL_S = 0.05

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Exception | None = None
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in it:
                    if not put(item):
                        return
            except Exception as e:
                self._err = e
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread (after the item it is fetching) and join it."""
        self._stop.set()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
