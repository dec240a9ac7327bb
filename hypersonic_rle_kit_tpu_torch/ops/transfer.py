"""Host <-> device copies of numpy arrays, through pinned buffers."""

from __future__ import annotations

import numpy as np
import torch


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``dev``; to CUDA through a pinned buffer."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def to_host(*ts: torch.Tensor) -> list[np.ndarray]:
    """Tensors -> numpy arrays; from CUDA through pinned buffers, every copy
    queued before one synchronisation."""
    outs, stream = [], None
    for t in ts:
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            stream = torch.cuda.current_stream(t.device)
            t = host
        outs.append(t)
    if stream is not None:
        stream.synchronize()
    return [t.numpy() for t in outs]
