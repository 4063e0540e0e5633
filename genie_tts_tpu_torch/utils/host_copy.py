"""Copies between host and device memory that do not wait for the device,
and the PCM16 cast the serving routes apply before the copy back."""
from __future__ import annotations

import numpy as np
import torch


def to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: through
    pinned memory with a non-blocking copy (a pageable copy would wait for
    the work already queued on the stream)."""
    t = torch.as_tensor(np.asarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def start_host_copy(t: torch.Tensor):
    """Enqueue ``t``'s copy to host memory behind the work that made it;
    :func:`finish_host_copy` waits for it. On the CPU the tensor is its own
    copy."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def finish_host_copy(handle) -> np.ndarray:
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()
