"""Copies of device tensors taken while the window runs, for the check
after it.  On a card each copy is issued on a side stream into a slab of
pinned host memory set aside in set-up, so the timed path holds no copy
in device memory and allocates nothing: it waits only where it is told
to (``fence``), before it overwrites in place what a copy reads.  On the
CPU a copy is a clone."""
from __future__ import annotations

from typing import Dict, Hashable, Optional

import torch

ALIGN = 64            # byte offsets of the copies in a slab


class Recorder:
    """``put`` copies under a key into the slab that ``start`` chose;
    ``get`` gives a copy back, on a device, in its own dtype."""

    def __init__(self, device: torch.device):
        self.dev = device
        self.side = torch.cuda.Stream(device) if device.type == 'cuda' \
            else None
        self.slabs = []
        self.slab: Optional[torch.Tensor] = None
        self.off, self.spilled = 0, 0
        self.items: Dict[Hashable, tuple] = {}

    def reserve(self, nbytes: int, n: int = 2) -> None:
        """``n`` slabs of ``nbytes`` pinned bytes each (none on the CPU)."""
        if self.side is not None:
            self.slabs = [torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(n)]

    def start(self, slab: int) -> Dict:
        """A new record into slab ``slab``; returns the items it fills."""
        self.slab = self.slabs[slab] if self.slabs else None
        self.off, self.items = 0, {}
        return self.items

    def _host(self, raw: torch.Tensor) -> torch.Tensor:
        n = raw.numel() * raw.element_size()
        if self.slab is not None and self.off + n <= self.slab.numel():
            h = self.slab[self.off:self.off + n].view(raw.dtype) \
                .view(raw.shape)
            self.off += -(-n // ALIGN) * ALIGN
            return h
        self.spilled += n           # past the slab: pinned on the spot
        return torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)

    def put(self, key: Hashable, t: torch.Tensor) -> None:
        t = t.detach()
        if self.side is None:
            self.items[key] = (t.clone(), t.dtype)
            return
        # fp8 has no pinned copy of its own: its bytes are copied
        raw = t.view(torch.uint8) if t.element_size() == 1 and \
            t.is_floating_point() else t
        self.side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.side):
            h = self._host(raw)
            h.copy_(raw, non_blocking=True)
        raw.record_stream(self.side)
        self.items[key] = (h, t.dtype)

    def fence(self) -> None:
        """The timed path waits for the copies issued so far."""
        if self.side is not None:
            torch.cuda.current_stream(self.dev).wait_stream(self.side)

    def used(self) -> int:
        """Bytes of the current record (slab and spill)."""
        if self.side is None:
            return sum(h.numel() * h.element_size()
                       for h, _ in self.items.values())
        return self.off + self.spilled

    def sync(self) -> None:
        if self.side is not None:
            self.side.synchronize()

    @staticmethod
    def get(items: Dict, key: Hashable, device: torch.device
            ) -> Optional[torch.Tensor]:
        if key not in items:
            return None
        h, dtype = items[key]
        t = h.to(device)
        return t.view(dtype) if t.dtype != dtype else t
