"""Process-sharded, resumable loading of (N, T, ...) corpora (port of
``pysvihmm_tpu/data/loader.py``).

Each process materialises only its own contiguous slice of the corpus (a
memory-mapped ``.npy`` pages in only the rows a batch touches) and hands
out batches on its device. The rank and world size come from
``torch.distributed`` when a process group is up, else 0 and 1. Batches are
gathered into pinned host memory and copied to the card on a copy stream of
their own; the step that reads a batch waits on that copy's event
(:meth:`ShardedSequenceLoader._ready`), so a prefetching thread can run
ahead of the steps without a step ever reading a batch whose copy has not
finished.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterator

import numpy as np
import torch

from ..utils.device import process_rank_world, resolve_device


def process_shard_bounds(total: int, num_processes: int, process_id: int) -> tuple[int, int]:
    """Contiguous [start, end) slice of the corpus owned by this process."""
    per = total // num_processes
    rem = total % num_processes
    start = process_id * per + min(process_id, rem)
    return start, start + per + (1 if process_id < rem else 0)


class ShardedSequenceLoader:
    """Minibatch iterator over this process's slice of an (N, T, ...) corpus.

    ``load_shard(start, end)`` is the user's IO function (a memmap slice,
    parquet, ...); it runs once, for this process's slice only. Batches are
    (batch_per_host, T, ...) tensors on ``device`` (the card when None), one
    epoch-shuffled pass at a time, shuffled within the process's slice.
    """

    def __init__(
        self,
        load_shard: Callable[[int, int], np.ndarray],
        total: int,
        device: torch.device | str | None,
        batch_per_host: int,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.batch_per_host = batch_per_host
        self.rank, world = process_rank_world()
        self.start, self.end = process_shard_bounds(total, world, self.rank)
        self.local = np.asarray(load_shard(self.start, self.end))
        self.seed = seed
        self.rng = np.random.default_rng(seed + self.rank)
        # batches reach the card on their own stream (created here, so that a
        # loader for the card fails at once without one)
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)

    @classmethod
    def from_npy(
        cls, path: str, device: torch.device | str | None, batch_per_host: int, seed: int = 0
    ) -> ShardedSequenceLoader:
        """Memory-mapped ``.npy`` corpus: the OS pages in only the rows each
        batch touches, so a 1M-sequence file never materialises in host
        memory."""
        arr = np.load(path, mmap_mode="r")
        return cls(lambda s, e: arr[s:e], len(arr), device, batch_per_host, seed)

    def _stage(self, rows: np.ndarray):
        """Gather ``rows`` of the slice into host memory (pinned for the card;
        only these rows are read) and start their copy to the device. Returns
        the batch on the CPU, or (batch on the card, the copy's event)."""
        B = len(rows)
        pin = self._copy_stream is not None
        dtype = torch.from_numpy(np.zeros(0, self.local.dtype)).dtype
        host = torch.empty((B, *self.local.shape[1:]), dtype=dtype, pin_memory=pin)
        # rows is a slice of a permutation of the slice's indices: in range
        np.take(self.local, rows, axis=0, out=host.numpy(), mode="clip")
        if not pin:
            return host.to(self.device)
        with torch.cuda.stream(self._copy_stream):
            batch = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return batch, ready

    def _ready(self, staged) -> torch.Tensor:
        """A staged batch, ordered on the consumer's current stream after its
        copy (and kept alive for that stream's use of it)."""
        if self._copy_stream is None:
            return staged
        batch, ready = staged
        current = torch.cuda.current_stream(self.device)
        current.wait_event(ready)
        batch.record_stream(current)
        return batch

    def _staged_epoch(self) -> Iterator:
        order = self.rng.permutation(len(self.local))
        B = self.batch_per_host
        for i in range(0, len(order) - B + 1, B):
            yield self._stage(order[i : i + B])

    def __iter__(self) -> Iterator[torch.Tensor]:
        return (self._ready(staged) for staged in self._staged_epoch())

    def batches_per_epoch(self) -> int:
        """Whole batches per epoch (the tail < batch_per_host is dropped,
        matching ``__iter__``'s range arithmetic)."""
        return len(self.local) // self.batch_per_host

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The shuffle permutation of epoch ``epoch``: a pure function of
        (seed, rank, epoch), JAX's ``(seed, process_index, epoch)``, so rank
        r's batches are JAX's process r's index for index, and any (epoch,
        batch) position of the stream can be re-derived after a restart from
        the step counter alone."""
        rng = np.random.default_rng((self.seed, self.rank, epoch))
        return rng.permutation(len(self.local))

    def stream(self, start_step: int = 0, depth: int = 2) -> Iterator[torch.Tensor]:
        """Infinite resumable batch stream, prefetched ``depth`` batches ahead.

        Batch ``s`` of the stream is batch ``s % batches_per_epoch()`` of
        epoch ``s // batches_per_epoch()`` under :meth:`epoch_order`, so a run
        restarted with ``start_step = steps_done`` sees exactly the batches
        the uninterrupted run would have seen.
        """
        B = self.batch_per_host
        bpe = self.batches_per_epoch()
        if bpe == 0:
            raise ValueError(f"shard has {len(self.local)} sequences < batch_per_host={B}")

        def staged():
            epoch, idx = divmod(start_step, bpe)
            while True:
                order = self.epoch_order(epoch)
                for i in range(idx, bpe):
                    yield self._stage(order[i * B : (i + 1) * B])
                epoch, idx = epoch + 1, 0

        return _prefetch_iter(staged(), depth, self._ready)

    def prefetch(self, depth: int = 2) -> Iterator[torch.Tensor]:
        """One epoch (as ``__iter__``) with the gathers and copies run ``depth``
        batches ahead of the consumer in a thread."""
        return _prefetch_iter(self._staged_epoch(), depth, self._ready)


def _prefetch_iter(source: Iterator, depth: int, take: Callable) -> Iterator:
    """Drive ``source`` from a thread into a ``depth``-deep queue; the
    consumer gets ``take(item)`` of each item, in order.

    An exception in ``source`` is put on the queue and raised in the
    consumer (JAX's poison pill). When the consumer stops (the generator is
    closed or collected), the thread stops too and is joined.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield take(item)
    finally:
        stop.set()
        thread.join()
