"""Host <-> device copies that do not stall the host (port counterpart of
``citlab_as_tpu/utils/async_copy.py``).

- :func:`upload`: host pages into a pinned staging buffer, then a
  ``non_blocking`` copy to the card on the current stream. The caching
  host allocator keeps the staging buffer until that copy has run.
- :func:`prefetch`: a device -> host copy into a pinned buffer with
  ``non_blocking=True`` on the tensor's current stream, followed by a
  recorded ``torch.cuda.Event``. :meth:`HostCopy.numpy` waits on that
  event only, never on the whole device.

On a CPU tensor both are plain copies.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch


def upload(arrays: Sequence[np.ndarray], device: torch.device) -> torch.Tensor:
    """``np.stack(arrays)`` as a tensor on ``device``."""
    first = np.asarray(arrays[0])
    if device.type != "cuda":
        return torch.from_numpy(np.stack(arrays)).to(device)
    staging = torch.empty((len(arrays),) + first.shape,
                          dtype=torch.from_numpy(np.empty(0, first.dtype)).dtype,
                          pin_memory=True)
    np.stack(arrays, out=staging.numpy())
    return staging.to(device, non_blocking=True)


class HostCopy:
    """A device -> host copy in flight (see :func:`prefetch`)."""

    def __init__(self, tensor: torch.Tensor):
        self.event: Optional[torch.cuda.Event] = None
        if tensor.device.type == "cuda":
            self.host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self.host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensor.device))
        else:
            self.host = tensor.detach().cpu()

    def numpy(self) -> np.ndarray:
        """The copied values; waits for the copy's event only."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def prefetch(tensor: torch.Tensor) -> HostCopy:
    """Start the device -> host copy of ``tensor`` behind the work queued on
    its current stream."""
    return HostCopy(tensor)


def to_numpy(x: Union[torch.Tensor, HostCopy]) -> np.ndarray:
    """A prefetched copy's values, or a tensor's by a synchronous copy."""
    if isinstance(x, HostCopy):
        return x.numpy()
    return x.cpu().numpy()
