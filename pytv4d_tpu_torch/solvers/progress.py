"""Host progress reporting from the solver loop.

The loss history stays on the device for the whole solve.  With
``progress_every=k`` the loop hands ``(iteration, loss)`` to a host
callback every k iterations; only those iterations read the loss back
(one device sync each), the others never leave the device.
"""

from __future__ import annotations

import sys


def default_progress(i, loss):
    print(f"[pytv4d_tpu_torch] iter {int(i):>6d}  loss {float(loss):.8g}",
          file=sys.stderr, flush=True)


def emit_progress(i: int, loss, progress_every: int, progress_fn=None):
    """Call once per loop iteration with its index and loss tensor."""
    if not progress_every or i % progress_every:
        return
    (progress_fn or default_progress)(i, float(loss))
