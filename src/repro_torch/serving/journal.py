"""Write-ahead session journal: crash-safe recovery for retained sessions.

The durability contract (DESIGN.md §14): a turn is *committed* when its
session record — exact KV page bytes (the hibernation payload) plus turn
metadata — has been atomically published to the journal directory. The
backend commits at ``collect()``, i.e. before the turn's result is
acknowledged to its caller, so the journal is write-ahead with respect to
everything the caller may have acted on. After an engine teardown every
journaled session is restored bit-exactly (the payload re-enters through
the checksummed swap path); only turns that were still in flight — never
acknowledged — are replayed.

Publication reuses the Checkpointer's atomic-publish pattern: each record
is written to ``<name>.tmp`` and ``os.replace``d over the final name, so a
crash mid-write leaves either the previous committed record or none — never
a torn one. Each record also carries a crc32 over its page bytes; a record
that fails its checksum at load is skipped (counted), not trusted.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, Optional

import numpy as np

try:                                 # registers bfloat16 & friends with
    import ml_dtypes  # noqa: F401  # numpy so np.dtype("bfloat16") resolves
except ImportError:                  # pure-numpy deployments: fp pages only
    ml_dtypes = None

__all__ = ["SessionJournal"]

_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def _fname(agent_id: str) -> str:
    """Filesystem-safe, collision-free record name for an agent id: a
    sanitized stem for humans plus a crc of the raw id for uniqueness."""
    stem = _SAFE.sub("_", agent_id)[:48]
    return f"{stem}-{zlib.crc32(agent_id.encode()):08x}.npz"


def _payload_crc(k_pages: np.ndarray, v_pages: np.ndarray) -> int:
    k = np.ascontiguousarray(k_pages)
    v = np.ascontiguousarray(v_pages)
    return zlib.crc32(v.tobytes(), zlib.crc32(k.tobytes()))


class SessionJournal:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.commits = 0
        self.skipped_corrupt = 0

    # ------------------------------------------------------------ write
    def commit(self, agent_id: str, payload: Dict):
        """Atomically publish a session's committed state. ``payload`` is
        the engine's ``export_session`` dict (k_pages / v_pages /
        num_tokens / last_tok / out_tokens / prompt)."""
        final = os.path.join(self.root, _fname(agent_id))
        tmp = final + ".tmp"
        # pages are written as raw bytes (uint8 view) with the dtype named
        # in the meta: npz cannot round-trip extension dtypes like bfloat16
        # (they come back as opaque void records)
        k_pages = np.ascontiguousarray(payload["k_pages"])
        v_pages = np.ascontiguousarray(payload["v_pages"])
        meta = {
            "agent_id": agent_id,
            "num_tokens": int(payload["num_tokens"]),
            "last_tok": int(payload["last_tok"]),
            "out_tokens": [int(t) for t in payload.get("out_tokens", ())],
            "dtype": str(k_pages.dtype),
            "crc": _payload_crc(k_pages, v_pages),
        }
        with open(tmp, "wb") as f:
            np.savez(f, k_pages=k_pages.view(np.uint8),
                     v_pages=v_pages.view(np.uint8),
                     prompt=np.asarray(payload["prompt"], np.int32),
                     meta=np.frombuffer(
                         json.dumps(meta).encode(), dtype=np.uint8))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)       # the commit point
        self.commits += 1

    def forget(self, agent_id: str):
        """Drop a session's record (session released for good)."""
        try:
            os.remove(os.path.join(self.root, _fname(agent_id)))
        except FileNotFoundError:
            pass

    # ------------------------------------------------------------- read
    def load(self, agent_id: str) -> Optional[Dict]:
        path = os.path.join(self.root, _fname(agent_id))
        if not os.path.exists(path):
            return None
        return self._read(path)

    def load_all(self) -> Dict[str, Dict]:
        """Every committed session, keyed by agent id. Corrupt records
        (checksum mismatch, unreadable file) are skipped and counted —
        recovery must never trust bytes it cannot verify."""
        out: Dict[str, Dict] = {}
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".npz"):
                continue
            rec = self._read(os.path.join(self.root, name))
            if rec is not None:
                out[rec.pop("agent_id")] = rec
        return out

    def _read(self, path: str) -> Optional[Dict]:
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                dt = np.dtype(meta["dtype"])
                k_pages = z["k_pages"].view(dt)
                v_pages = z["v_pages"].view(dt)
                prompt = z["prompt"]
            if _payload_crc(k_pages, v_pages) != meta["crc"]:
                raise ValueError("journal payload failed its checksum")
        except Exception:
            self.skipped_corrupt += 1
            return None
        return {"agent_id": meta["agent_id"], "k_pages": k_pages,
                "v_pages": v_pages, "num_tokens": meta["num_tokens"],
                "last_tok": meta["last_tok"],
                "out_tokens": meta["out_tokens"], "prompt": prompt}
