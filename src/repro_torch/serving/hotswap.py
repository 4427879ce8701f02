"""``ParamStore``: the train -> serve handoff (counterpart of
``repro/serving/hotswap.py``).

The async federated loop (``fl/async_loop.run_federated_async``) makes a
new global model at every buffered aggregation; the serving engine adopts
each one between decode steps (``ServeEngine.maybe_swap``) without ever
seeing a half-written parameter set.  The store keeps one flat fp32 buffer
in the layout of ``fl.flatbuf.FlatLayout``:

* **A buffer the store owns.**  ``publish(params)`` flattens the tree into
  a fresh buffer; ``publish_flat(g_flat)`` copies the fused loop's flat
  global (``FlatLayout.copy``).  PyTorch tensors are mutable, where the
  reference's JAX arrays are not: the loop's server step overwrites and
  frees its flat buffers, so the store never keeps the caller's tensor.
* **Atomic versioned snapshots.**  The (version, buffer) pair changes
  under one lock, and ``snapshot`` returns both together: a reader sees
  the whole version-``v`` buffer or the whole version-``v+1`` one, since
  a published buffer is never written again.
* **Streams.**  On the card the copy is enqueued on the publisher's
  current stream; ``_install`` records an event after it, and
  ``snapshot`` makes the reader's current stream wait on that event, so a
  buffer published from another stream or thread is whole before any work
  the reader enqueues reads it.

``on_aggregate`` is the adapter handed to
``run_federated_async(..., on_aggregate=store.on_aggregate)``.
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch.fl.flatbuf import FlatLayout

Params = Any


class ParamStore:
    """Versioned single-slot store of the latest published global
    params."""

    def __init__(self, layout: FlatLayout):
        self.layout = layout
        self._lock = threading.Lock()
        self._flat: Optional[torch.Tensor] = None
        self._ready: Optional[torch.cuda.Event] = None
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def publish(self, params: Params) -> int:
        """Snapshot a params tree (flattened into a fresh buffer); returns
        the new version."""
        return self._install(self.layout.flatten(params))

    def publish_flat(self, g_flat: torch.Tensor) -> int:
        """Snapshot an existing flat global buffer (a copy: the publisher
        may overwrite or free its own at once); returns the new
        version."""
        return self._install(self.layout.copy(g_flat))

    def _install(self, flat: torch.Tensor) -> int:
        ready = None
        if flat.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(flat.device))
        with self._lock:
            self._flat, self._ready = flat, ready
            self._version += 1
            return self._version

    def snapshot(self) -> Tuple[int, Optional[torch.Tensor], FlatLayout]:
        """Atomic (version, flat buffer, layout).  The buffer is never
        written again; on the card the caller's current stream first waits
        for its copy to finish."""
        with self._lock:
            if self._ready is not None:
                torch.cuda.current_stream(self._flat.device).wait_event(
                    self._ready)
            return self._version, self._flat, self.layout

    # ------------------------------------------------------------------
    # fl/async_loop.py hook
    # ------------------------------------------------------------------
    def on_aggregate(self, version: int, params: Params,
                     g_flat: Optional[torch.Tensor] = None) -> None:
        """``run_federated_async`` callback: publish each aggregation,
        copying the loop's flat global where it has one rather than
        flattening the tree again."""
        if g_flat is not None:
            self.publish_flat(g_flat)
        else:
            self.publish(params)
