"""Where an entry point computes: the one rule every front-end shares.

- A ``torch.Tensor`` stays on its own device.  Passing a CPU tensor is how
  a caller asks for the CPU.
- Anything else (a numpy array, a list) goes to the CUDA device, as the JAX
  package puts it on its default accelerator.  Without a CUDA device that
  raises ``RuntimeError``: nothing carries on on the CPU unasked.
- ``device=`` names the device for such an input explicitly
  (``device="cpu"`` to compute on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch


def on_device(a, device=None, dtype=None):
    """``a`` as a tensor by the rule above.  ``dtype`` (a torch dtype)
    converts a non-tensor input; by default it keeps the array's own."""
    if isinstance(a, torch.Tensor):
        return a
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a numpy input goes to the CUDA device, and none is "
                "available; pass device='cpu' or a torch tensor to compute "
                "on its own device")
        device = torch.device("cuda")
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
