"""axiomhq/hyperloglog wire codec — Set-metric interop with reference fleets.

The reference serializes Set state with the vendored axiomhq sketch's
``MarshalBinary`` (the reference's ``samplers/samplers.go:441-465``,
``vendor/github.com/axiomhq/hyperloglog/hyperloglog.go:273-318``). Layout:

    byte 0   version (1)
    byte 1   p  (dense precision, 4..18)
    byte 2   b  (register base offset; registers store value-b clipped
                 to a 4-bit "tailcut", hyperloglog.go:166-186)
    byte 3   sparse flag

    dense  (flag 0): u32be size (= 2^p / 2), then size bytes, each
        packing registers 2i (high nibble) and 2i+1 (low nibble);
        true register value = b + nibble (after a rebase every register
        is >= b, and nibble 0 means exactly b; with b=0, 0 is empty)
    sparse (flag 1): u32be tmpSet count, count x u32be encoded hashes,
        then the compressedList: u32be count, u32be last, u32be byte
        length, varint-delta bytes (7-bit groups little-endian, high bit
        = continuation; value = previous + delta, compressed.go:102-124)

    sparse hash encoding (sparse.go:7-36, pp = 25):
        k & 1 == 1:  idx = top p bits of k[31:25+...]; rho carried in
                     bits 1..6 plus (pp - p)
        k & 1 == 0:  idx = bits [pp-p+1 : pp+1); rho = clz32 of
                     k << (32-pp+p-1), + 1

Decoding converts either representation to a dense uint8 register array
our ``SetGroup`` merges with elementwise max; encoding emits the dense
layout a reference global's ``UnmarshalBinary`` + ``Merge`` accepts.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

VERSION = 1
PP = 25  # the sparse precision constant (hyperloglog.go:13)
CAPACITY = 16  # tailcut range: nibble 0..15


class AxiomhqFormatError(ValueError):
    pass


def looks_like(blob: bytes) -> bool:
    """Cheap sniff: version 1, plausible precision, sparse flag 0/1."""
    return (len(blob) >= 4 and blob[0] == VERSION
            and 4 <= blob[1] <= 18 and blob[3] in (0, 1))


def decode(blob: bytes) -> Tuple[np.ndarray, int]:
    """axiomhq MarshalBinary bytes → (dense uint8 registers [2^p], p)."""
    if len(blob) < 4:
        raise AxiomhqFormatError("truncated axiomhq header")
    version, p, b, sparse = blob[0], blob[1], blob[2], blob[3]
    if version != VERSION:
        raise AxiomhqFormatError(f"unsupported axiomhq version {version}")
    if not 4 <= p <= 18:
        raise AxiomhqFormatError(f"precision {p} out of range")
    m = 1 << p
    if sparse == 0:
        (sz,) = struct.unpack_from(">I", blob, 4)
        if sz != m // 2:
            raise AxiomhqFormatError(
                f"dense register block is {sz} bytes, want {m // 2}")
        if len(blob) < 8 + sz:
            raise AxiomhqFormatError("truncated dense register block")
        packed = np.frombuffer(blob, np.uint8, count=sz, offset=8)
        regs = np.empty(m, np.uint8)
        regs[0::2] = packed >> 4
        regs[1::2] = packed & 0x0F
        if b:
            # after a rebase every register holds value-b; nibble 0 means
            # exactly b (registers.go:55-72 keeps relative zeros only at
            # the minimum)
            regs = regs + np.uint8(b)
        return regs, p
    # sparse: tmpSet then compressedList, every entry an encoded hash
    (ts_count,) = struct.unpack_from(">I", blob, 4)
    pos = 8
    end_ts = pos + 4 * ts_count
    if len(blob) < end_ts + 12:
        raise AxiomhqFormatError("truncated sparse tmpSet")
    keys = [np.frombuffer(blob, ">u4", count=ts_count, offset=pos)
            .astype(np.uint32)]
    pos = end_ts
    _count, _last, nbytes = struct.unpack_from(">III", blob, pos)
    pos += 12
    if len(blob) < pos + nbytes:
        raise AxiomhqFormatError("truncated sparse compressed list")
    data = blob[pos:pos + nbytes]
    # varint-delta walk (compressed.go:102-124 + 158-168)
    vals = []
    x = 0
    shift = 0
    last = 0
    for byte in data:
        if byte & 0x80:
            x |= (byte & 0x7F) << shift
            shift += 7
        else:
            x |= byte << shift
            last = (last + x) & 0xFFFFFFFF
            vals.append(last)
            x = 0
            shift = 0
    if shift:
        raise AxiomhqFormatError("dangling varint in sparse list")
    keys.append(np.asarray(vals, np.uint32))
    k = np.concatenate(keys)
    regs = np.zeros(m, np.uint8)
    if len(k):
        idx, rho = _decode_hashes(k, p)
        np.maximum.at(regs, idx, rho)
    return regs, p


def _decode_hashes(k: np.ndarray, p: int):
    """Vectorized decodeHash (sparse.go:25-36)."""
    odd = (k & 1) == 1
    idx = np.where(
        odd,
        (k >> np.uint32(32 - p)) & np.uint32((1 << p) - 1),
        (k >> np.uint32(PP - p + 1)) & np.uint32((1 << p) - 1),
    ).astype(np.int64)
    # odd: rho stored in bits 1..6, biased by pp-p
    rho_odd = ((k >> np.uint32(1)) & np.uint32(0x3F)) + np.uint32(PP - p)
    # even: rho = clz32(k << (32-pp+p-1)) + 1
    shifted = (k << np.uint32(32 - PP + p - 1)) & np.uint32(0xFFFFFFFF)
    # count leading zeros of a u32: 31 - floor(log2(x)); x==0 -> 32
    safe = np.maximum(shifted, 1)
    clz = np.uint32(31) - np.floor(np.log2(safe)).astype(np.uint32)
    clz = np.where(shifted == 0, np.uint32(32), clz)
    rho = np.where(odd, rho_odd, clz + np.uint32(1)).astype(np.uint8)
    return idx, rho


def encode_dense(registers: np.ndarray, p: int) -> bytes:
    """Dense uint8 registers → axiomhq dense MarshalBinary bytes.

    Chooses the base b the way the real sketch's rebase invariant ends
    up: b = min(register) when every register is nonzero, else 0 (a zero
    register with b > 0 would decode as b). Values past b + 15 clip to
    the 4-bit tailcut exactly as the reference's own inserts do
    (hyperloglog.go:180-186)."""
    regs = np.asarray(registers, np.uint8)
    m = 1 << p
    if regs.shape != (m,):
        raise ValueError(f"want {m} registers, got {regs.shape}")
    rmin = int(regs.min()) if m else 0
    b = rmin if rmin > 0 else 0
    rel = np.minimum(regs - np.uint8(b), np.uint8(CAPACITY - 1))
    packed = ((rel[0::2] << np.uint8(4)) | rel[1::2]).astype(np.uint8)
    return (bytes((VERSION, p, b, 0)) + struct.pack(">I", m // 2)
            + packed.tobytes())
