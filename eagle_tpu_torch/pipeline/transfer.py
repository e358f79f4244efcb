"""Device-to-host drain (counterpart of ``eagle_tpu/pipeline/transfer.py``).

Every separate device-to-host copy is a synchronising call on the host.
When several device tensors become ready at the same point of the
program, reading them as ONE flattened copy replaces k waits with one, at
the cost of a device-side concatenation.
"""

from __future__ import annotations

import numpy as np
import torch


def drain_together(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Several tensors of one device as numpy arrays, through one
    ``torch.cat`` of their flattened values and one ``.cpu()``.

    Unlike the JAX package's, the tensors may differ in dtype: each is
    carried as float64 (exact for bool, the integers below 2**53 and
    float32) and comes back as its own dtype and shape."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        size = t.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(flat[off : off + size].reshape(tuple(t.shape)).astype(dtype))
        off += size
    return out
