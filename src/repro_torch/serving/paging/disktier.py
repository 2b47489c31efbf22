"""Disk spill tier below the host-RAM ``KVSwapStore`` (DESIGN.md §15).

The host-RAM swap tier bounds how many sessions can hibernate at once;
a long-lived fleet (or a drain that evicts a whole engine's worth of
sessions) needs more headroom than RAM. ``DiskTierKVSwapStore`` keeps
the hot set in RAM and writes the least-recently-used payloads back to
a spill directory once RAM occupancy crosses ``capacity_bytes``:

  * put()  — lands in RAM, then LRU-writeback until under capacity
  * peek() — RAM hit refreshes recency; a disk hit reads the file back,
             verifies crc32, promotes to RAM, and may spill another key
  * pop()  — drains from whichever tier holds the payload

Every spilled file carries a crc32 over the raw page bytes; a mismatch
on read-back raises ``SwapCorruptionError`` — the same typed failure
the checksummed swap path uses, so one bit-rotted spill file condemns
one session instead of poisoning a wake. Files use the tmp + ``fsync``
+ ``os.replace`` commit discipline of the session journal.

Payloads are the swap manager's ``(k_pages, v_pages, num_tokens)``
tuples; bf16 pools round-trip as uint8 views with the dtype name in
the sidecar metadata (numpy cannot save bf16 natively).
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.context.tiers import KV_DISK_LATENCY_S, KVSwapStore
from repro_torch.serving.errors import SwapCorruptionError, SwapIOError

__all__ = ["DiskTierKVSwapStore"]


def _to_u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


class DiskTierKVSwapStore(KVSwapStore):
    """Two-tier swap store: host RAM with LRU writeback to a spill dir."""

    def __init__(self, spill_dir: str, capacity_bytes: int = 64 << 20,
                 disk_latency_s: float = KV_DISK_LATENCY_S):
        super().__init__()
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive")
        if disk_latency_s < 0:
            raise ValueError("disk_latency_s must be non-negative")
        self.spill_dir = spill_dir
        self.capacity_bytes = int(capacity_bytes)
        # simulated per-file transfer cost, charged on top of the RAM
        # tier's KV_SWAP_LATENCY_S and fed to the CLM cost model through
        # the shared sim_latency_s ledger
        self.disk_latency_s = float(disk_latency_s)
        os.makedirs(spill_dir, exist_ok=True)
        # key -> (path, nbytes); dict order is spill order (oldest first)
        self._disk: Dict[object, Tuple[str, int]] = {}
        self._seq = 0
        self.disk_writebacks = 0
        self.disk_reads = 0
        self.disk_bytes_held = 0
        self.disk_sim_latency_s = 0.0

    # ------------------------------------------------------------ tiers
    def _ram_bytes(self) -> int:
        return int(sum(self._bytes.values()))

    def _touch(self, key):
        """Refresh RAM recency: dict order doubles as the LRU list."""
        self._pages[key] = self._pages.pop(key)
        self._bytes[key] = self._bytes.pop(key)

    def _spill_path(self, key) -> str:
        self._seq += 1
        safe = "".join(c if c.isalnum() else "_" for c in str(key))[:40]
        return os.path.join(self.spill_dir, f"kv-{safe}-{self._seq}.npz")

    def _writeback(self):
        """LRU writeback until the RAM tier fits under capacity. Keeps at
        least one resident payload so a single oversized session cannot
        thrash put→spill→read-back forever."""
        while self._ram_bytes() > self.capacity_bytes and len(self._pages) > 1:
            key = next(iter(self._pages))      # oldest = least recent
            payload = self._pages.pop(key)
            nbytes = self._bytes.pop(key)
            k_pages, v_pages, num_tokens = payload
            k8, v8 = _to_u8(k_pages), _to_u8(v_pages)
            crc = zlib.crc32(v8.tobytes(), zlib.crc32(k8.tobytes()))
            meta = {"dtype": str(k_pages.dtype),
                    "k_shape": list(k_pages.shape),
                    "v_shape": list(v_pages.shape),
                    "num_tokens": int(num_tokens), "crc": crc}
            path = self._spill_path(key)
            tmp = path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, k=k8, v=v8,
                             meta=np.frombuffer(
                                 json.dumps(meta).encode(), np.uint8))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except OSError as e:
                # a failed spill is not data loss — keep the payload hot
                self._pages[key] = payload
                self._bytes[key] = nbytes
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise SwapIOError(f"disk spill failed for {key!r}") from e
            self._disk[key] = (path, nbytes)
            self.disk_writebacks += 1
            self.disk_bytes_held += nbytes
            self.accesses += 1
            self.disk_sim_latency_s += self.disk_latency_s
            self.sim_latency_s += self.disk_latency_s

    def _load(self, key):
        """Read a spilled payload back, crc-verified. Removes the file."""
        path, nbytes = self._disk.pop(key)
        self.disk_bytes_held -= nbytes
        try:
            with np.load(path) as z:
                k8, v8 = z["k"], z["v"]
                meta = json.loads(bytes(z["meta"]).decode())
        except FileNotFoundError as e:
            raise SwapIOError(f"disk read-back failed for {key!r}") from e
        except Exception as e:  # noqa: BLE001 — torn zip, bad json, ...
            # an unreadable container IS corruption: the zip layer's own
            # crc can trip before ours gets to compare page bytes
            raise SwapCorruptionError(
                f"spilled KV pages for session {key!r} unreadable on "
                f"read-back: {e}") from e
        finally:
            if os.path.exists(path):
                os.unlink(path)
        crc = zlib.crc32(v8.tobytes(), zlib.crc32(k8.tobytes()))
        if crc != meta["crc"]:
            raise SwapCorruptionError(
                f"spilled KV pages for session {key!r} failed crc32 on "
                f"read-back (stored {meta['crc']:#010x}, got {crc:#010x})")
        self.disk_reads += 1
        self.accesses += 1
        self.disk_sim_latency_s += self.disk_latency_s
        self.sim_latency_s += self.disk_latency_s
        try:
            import ml_dtypes
            dtype = np.dtype(getattr(ml_dtypes, meta["dtype"], meta["dtype"]))
        except ImportError:             # pragma: no cover - jax ships it
            dtype = np.dtype(meta["dtype"])
        k = k8.view(dtype).reshape(meta["k_shape"])
        v = v8.view(dtype).reshape(meta["v_shape"])
        return (k, v, meta["num_tokens"]), nbytes

    # --------------------------------------------------- KVSwapStore API
    def put(self, key, payload, nbytes: int):
        assert key not in self._disk, f"session {key!r} already spilled"
        super().put(key, payload, nbytes)
        self._writeback()

    def peek(self, key):
        if key in self._pages:
            self._touch(key)
            return self._pages[key]
        payload, nbytes = self._load(key)       # promote to RAM
        self._pages[key] = payload
        self._bytes[key] = nbytes
        self._writeback()
        return payload

    def pop(self, key):
        if key in self._pages:
            return super().pop(key)
        payload, nbytes = self._load(key)
        self.bytes_stored -= nbytes
        self.bytes_out += nbytes
        return payload

    def __contains__(self, key) -> bool:
        return key in self._pages or key in self._disk

    def __len__(self) -> int:
        return len(self._pages) + len(self._disk)

    def tier_stats(self) -> dict:
        out = super().tier_stats()
        out.update({
            "swap_disk_sessions": len(self._disk),
            "swap_disk_bytes": int(self.disk_bytes_held),
            "swap_disk_writebacks": int(self.disk_writebacks),
            "swap_disk_reads": int(self.disk_reads),
            "swap_disk_latency_s": float(self.disk_sim_latency_s),
            "swap_ram_capacity_bytes": int(self.capacity_bytes),
        })
        return out
