"""Background prefetch: host decode and preprocessing, and the copy to the
device, overlap the edit (port of ``rgie_tpu/data/prefetch.py``).

A producer thread decodes and preprocesses a batch (through the native C++
feeder when it loads), pins it and starts its copy to the device with
``non_blocking=True`` one batch ahead, so the card does not wait on PIL. On
the CPU the batch is handed over as a tensor, unpinned.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def to_device(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch as a tensor on ``device``: pinned and copied
    asynchronously to a CUDA device, as it is for the CPU."""
    tensor = torch.from_numpy(np.ascontiguousarray(images))
    if device.type != "cuda":
        return tensor
    return tensor.pin_memory().to(device, non_blocking=True)


class PrefetchIterator:
    """Wrap a host ``(images, meta)`` iterator with a ``depth``-deep
    background queue; with ``device``, each batch's images arrive as a tensor
    on it, the copy started by the producer thread. An error in the producer
    is raised here, at the batch where it happened."""

    _SENTINEL = object()

    def __init__(self, iterator, depth: int = 2, device: Optional[torch.device] = None):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device = device
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, args=(iterator,), daemon=True)
        self._thread.start()

    def _worker(self, iterator):
        try:
            for images, meta in iterator:
                if self._device is not None:
                    # Enqueued on the device's default stream, which the
                    # consumer's work follows.
                    images = to_device(images, self._device)
                self._queue.put((images, meta))
        except BaseException as e:  # surfaced on the consumer's side
            self._error = e
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def prefetch_batches(dataset, batch_size: int, input_size: int, crop_size: int,
                     normalize: bool = False, limit: Optional[int] = None, depth: int = 2,
                     device: Optional[torch.device] = None,
                     use_native: bool = True) -> Iterator[Tuple[object, list]]:
    """Batched, prefetched dataset iterator: the batches of
    ``data.dataset.iterate_batches``, the resize, crop and normalize in the
    C++ pool with ``use_native`` (``data.native_preprocess``), on ``device``
    when one is given."""

    def gen():
        from rgie_tpu_torch.data.dataset import preprocess_image
        from rgie_tpu_torch.data.native_preprocess import native_available, preprocess_batch

        native = use_native and native_available()
        n = len(dataset) if limit is None else min(limit, len(dataset))
        raw_imgs, metas = [], []
        for i in range(n):
            img, meta = dataset[i]
            raw_imgs.append(img)
            metas.append(meta)
            if len(raw_imgs) == batch_size or i == n - 1:
                if native:
                    batch = preprocess_batch(raw_imgs, input_size, crop_size, normalize)
                else:
                    batch = np.concatenate([preprocess_image(im, input_size, crop_size, normalize)
                                            for im in raw_imgs])
                yield batch, metas
                raw_imgs, metas = [], []

    return PrefetchIterator(gen(), depth=depth, device=device)
