"""CUDA-aware prefetch: overlap chunk fetch, host staging, and the upload.

Own copy of ``bioengine_tpu/datasets/prefetch.py``. This is a NEW
capability over the reference (whose data path stops at process RAM, ref
bioengine/datasets/http_zarr_store.py): batches are pipelined chunk ->
host numpy -> pinned host memory -> the card, so the accelerator never
waits on the network. Double-buffering depth is configurable.

On the card each array is staged into pinned (page-locked) host memory,
because a ``non_blocking`` copy from pageable memory is synchronous, and
copied on a dedicated copy stream; an event recorded after a batch's
copies is what the consumer's stream waits on before the batch is
yielded, and ``record_stream`` keeps the copy stream's allocator from
handing a yielded tensor's memory to a later batch while the consumer
still reads it. PyTorch's pinned-memory allocator records each copy on
its stream, so a staging buffer is not reused before its copy is done.

With a ``sharding`` (a ``parallel.mesh.Placement``) each leaf is split on
the host over the mesh, or copied whole to every entry for ``replicated``,
and lands as ``shard_batch``'s structure (``Shards`` or ``Replicated``);
each device of the mesh has its own copy stream and its own event, which
that device's consumer stream waits on.
"""

from __future__ import annotations

import asyncio
import collections
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from bioengine_tpu_torch.datasets.http_zarr_store import RemoteZarrArray
from bioengine_tpu_torch.parallel.data_parallel import host_parts, place, tree_map
from bioengine_tpu_torch.parallel.mesh import Placement
from bioengine_tpu_torch.runtime.devices import DeviceLike, resolve_device


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    device: DeviceLike = None,
    sharding: Optional[Placement] = None,
) -> Iterator[Any]:
    """Wrap a host-batch iterator, keeping ``size`` batches in flight on
    device. Works on dicts, lists and tuples of numpy arrays. ``device``
    None is ``cuda:0`` (raising without CUDA); ``"cpu"`` yields plain
    tensors, no stream involved. ``sharding`` places every leaf over its
    mesh instead (``device`` is not used)."""
    if sharding is not None:
        if all(d.type == "cpu" for d in sharding.mesh.devices):
            put = lambda batch: (  # noqa: E731
                tree_map(lambda x: place(sharding, np.array(x)), batch), None
            )
        else:
            put = _ShardedCopy(sharding).put
        return _prefetch(iter(iterator), size, put)
    dev = resolve_device(device)
    if dev.type == "cpu":
        put = lambda batch: (  # noqa: E731
            tree_map(lambda x: torch.from_numpy(np.array(x)), batch), None
        )
    else:
        put = _CopyStream(dev).put
    return _prefetch(iter(iterator), size, put)


def _prefetch(it: Iterator[Any], size: int, put) -> Iterator[Any]:
    queue: collections.deque = collections.deque()
    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        batch, ready = queue.popleft()
        if ready is not None:
            ready(batch)
        yield batch
        try:
            queue.append(put(next(it)))
        except StopIteration:
            continue


class _CopyStream:
    """Host batches onto ``device`` over pinned staging and a copy stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def put(self, batch: Any) -> tuple[Any, Callable[[Any], None]]:
        def copy(x):
            host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            out = tree_map(copy, batch)
            done = torch.cuda.Event()
            done.record(self.stream)

        def ready(tensors: Any) -> None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            tree_map(lambda t: t.record_stream(consumer), tensors)

        return out, ready


class _ShardedCopy:
    """Host batches over a mesh: each leaf split on the host (or whole,
    replicated), every part pinned and copied on its device's copy
    stream."""

    def __init__(self, placement: Placement):
        self.placement = placement
        self.streams = {d: torch.cuda.Stream(d) for d in dict.fromkeys(placement.mesh.devices)}

    def put(self, batch: Any) -> tuple[Any, Callable[[Any], None]]:
        mesh = self.placement.mesh
        copied: list[torch.Tensor] = []

        def copy(x):
            kind, parts = host_parts(self.placement, np.ascontiguousarray(x))
            pinned = {}
            out = []
            for part, dev in zip(parts, mesh.devices):
                host = pinned.get(id(part))
                if host is None:  # a replicated leaf is pinned once
                    host = pinned[id(part)] = part.contiguous().pin_memory()
                with torch.cuda.stream(self.streams[dev]):
                    out.append(host.to(dev, non_blocking=True))
            copied.extend(out)
            return kind(out, mesh)

        out = tree_map(copy, batch)
        done = {}
        for dev, stream in self.streams.items():
            done[dev] = torch.cuda.Event()
            done[dev].record(stream)

        def ready(_: Any) -> None:
            for dev, event in done.items():
                torch.cuda.current_stream(dev).wait_event(event)
            for t in copied:
                t.record_stream(torch.cuda.current_stream(t.device))

        return out, ready


class ZarrBatchLoader:
    """Stream batches of rows from a RemoteZarrArray into device memory.

    Reads ``batch_size`` leading-axis slices ahead of the consumer on a
    background thread running its own event loop (the training loop is
    synchronous code), then hands them to :func:`prefetch_to_device` on
    ``device`` (None: ``cuda:0``; ``"cpu"``: plain tensors), or over
    ``sharding``'s mesh.
    """

    def __init__(
        self,
        array: RemoteZarrArray,
        batch_size: int,
        indices: Optional[Sequence[int]] = None,
        prefetch_batches: int = 2,
        drop_remainder: bool = True,
        device: DeviceLike = None,
        sharding: Optional[Placement] = None,
    ):
        self.array = array
        self.batch_size = batch_size
        self.indices = list(
            indices if indices is not None else range(array.shape[0])
        )
        self.prefetch_batches = prefetch_batches
        self.drop_remainder = drop_remainder
        self.sharding = sharding
        self.device = sharding.mesh.devices[0] if sharding is not None else resolve_device(device)

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _batches(self) -> Iterator[list[int]]:
        for i in range(0, len(self.indices), self.batch_size):
            batch = self.indices[i : i + self.batch_size]
            if len(batch) < self.batch_size and self.drop_remainder:
                return
            yield batch

    def host_batches(self) -> Iterator[np.ndarray]:
        """Yield numpy batches, fetched by a background asyncio thread."""
        q: "collections.deque[Any]" = collections.deque()
        done = threading.Event()
        error: list[BaseException] = []
        sem = threading.Semaphore(self.prefetch_batches)

        async def _fetch_all():
            for batch in self._batches():
                rows = await asyncio.gather(
                    *(
                        self.array.read(
                            (slice(idx, idx + 1),)
                            + tuple(slice(0, s) for s in self.array.shape[1:])
                        )
                        for idx in batch
                    )
                )
                await asyncio.to_thread(sem.acquire)
                q.append(np.concatenate(rows, axis=0))

        def _runner():
            try:
                asyncio.run(_fetch_all())
            except BaseException as e:  # surfaced to the consumer
                error.append(e)
            finally:
                done.set()

        thread = threading.Thread(target=_runner, daemon=True)
        thread.start()
        while True:
            if q:
                yield q.popleft()
                sem.release()
            elif done.is_set():
                if error:
                    raise error[0]
                if not q:
                    return
            else:
                done.wait(timeout=0.005)

    def __iter__(self) -> Iterator[Any]:
        return prefetch_to_device(
            self.host_batches(), size=self.prefetch_batches, device=self.device,
            sharding=self.sharding,
        )
