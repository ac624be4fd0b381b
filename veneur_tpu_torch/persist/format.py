"""The checkpoint file format: versioned, CRC-guarded, atomically written.

Port of ``veneur_tpu/persist/format.py``, byte for byte in what it
writes: the same snapshot dict serializes to the same bytes in both
packages, and each package restores the other's checkpoints.

One checkpoint file holds a complete host-side snapshot of the store's
dense state (``MetricStore.snapshot_state``): interner keys, scalar
arrays, digest centroid runs, HLL registers and count-min rows. Layout:

    offset 0   magic   b"VCKP"
    offset 4   u16     format version (1)
    offset 6   u16     flags (0)
    offset 8   u64     payload length (truncation check)
    offset 16  u32     CRC-32 of the payload (corruption check)
    offset 20  payload = u32 manifest length + JSON manifest + arena

The manifest is JSON (group structure, interner strings, metadata);
every numpy array is spilled into the binary arena and referenced as
``{"__a__": {"o": offset, "n": count, "d": dtype, "s": shape}}``.

Durability contract: ``write_atomic`` writes ``path + ".tmp"``, fsyncs,
then ``os.replace``s over ``path`` — a reader (including a recovering
process) can NEVER observe a partial file, only the previous complete
checkpoint or the new one. ``deserialize`` validates magic, version,
length and CRC before touching the manifest and raises
:class:`CheckpointInvalid` (with a telemetry ``reason``) on anything it
cannot prove whole — a malformed checkpoint is discarded, never
half-applied.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger("veneur.persist")

MAGIC = b"VCKP"
VERSION = 1
_HEADER = struct.Struct("<4sHHQI")  # magic, version, flags, payload, crc
_MANIFEST_LEN = struct.Struct("<I")


class CheckpointInvalid(Exception):
    """The file is not a usable checkpoint. ``reason`` is a short
    machine-friendly slug (truncated / corrupt / bad-magic /
    bad-version / malformed / stale) for discard telemetry."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"{reason}: {detail}" if detail else reason)


def serialize(groups: Dict[str, dict], created_at: float,
              interval: float, meta: Optional[dict] = None) -> bytes:
    """Snapshot dict (``MetricStore.snapshot_state``) → checkpoint bytes."""
    arena = bytearray()

    def ref(arr: np.ndarray) -> dict:
        arr = np.ascontiguousarray(arr)
        off = len(arena)
        arena.extend(arr.tobytes())
        return {"o": off, "n": int(arr.size), "d": arr.dtype.str,
                "s": list(arr.shape)}

    enc_groups: Dict[str, dict] = {}
    for name, snap in groups.items():
        enc_groups[name] = {
            k: ({"__a__": ref(v)} if isinstance(v, np.ndarray) else v)
            for k, v in snap.items()}
    manifest = {"created_at": float(created_at),
                "interval": float(interval), "groups": enc_groups,
                # nested so caller metadata can never clobber the
                # reserved keys above
                "meta": dict(meta or {})}
    mbytes = json.dumps(manifest, separators=(",", ":")).encode("utf-8")
    payload = _MANIFEST_LEN.pack(len(mbytes)) + mbytes + bytes(arena)
    header = _HEADER.pack(MAGIC, VERSION, 0, len(payload),
                          zlib.crc32(payload))
    return header + payload


def deserialize(blob: bytes) -> Tuple[Dict[str, dict], dict]:
    """Checkpoint bytes → (groups, manifest-metadata). Raises
    :class:`CheckpointInvalid`; never returns partially-decoded state."""
    if len(blob) < _HEADER.size:
        raise CheckpointInvalid("truncated",
                               f"{len(blob)} bytes < header")
    magic, version, _flags, payload_len, crc = _HEADER.unpack_from(blob)
    if magic != MAGIC:
        raise CheckpointInvalid("bad-magic", repr(magic))
    if version != VERSION:
        raise CheckpointInvalid("bad-version", str(version))
    payload = blob[_HEADER.size:]
    if len(payload) != payload_len:
        raise CheckpointInvalid(
            "truncated", f"payload {len(payload)} != {payload_len}")
    if zlib.crc32(payload) != crc:
        raise CheckpointInvalid("corrupt", "CRC mismatch")
    try:
        (mlen,) = _MANIFEST_LEN.unpack_from(payload)
        manifest = json.loads(
            payload[_MANIFEST_LEN.size:_MANIFEST_LEN.size + mlen])
        arena = payload[_MANIFEST_LEN.size + mlen:]
        groups: Dict[str, dict] = {}
        for name, enc in manifest.pop("groups").items():
            snap = {}
            for k, v in enc.items():
                if isinstance(v, dict) and "__a__" in v:
                    r = v["__a__"]
                    snap[k] = np.frombuffer(
                        arena, dtype=np.dtype(r["d"]), count=r["n"],
                        offset=r["o"]).reshape(r["s"]).copy()
                else:
                    snap[k] = v
            groups[name] = snap
    except CheckpointInvalid:
        raise
    except Exception as e:
        raise CheckpointInvalid("malformed", str(e))
    return groups, manifest


def write_atomic(path: str, blob: bytes) -> int:
    """temp + fsync + rename so readers never see a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:  # best-effort directory durability (the rename itself)
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    return len(blob)


def read_file(path: str) -> Optional[bytes]:
    """Whole-file read; None when the checkpoint does not exist."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None
