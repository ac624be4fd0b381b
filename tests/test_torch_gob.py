"""The port's reference-format codecs against the JAX package's: the Go
gob t-digest stream (``protocol/gob.py``) and the axiomhq HLL sketch
(``ops/axiomhq.py``).

One parametrised test over seeded digests (edge values included: zeros,
negatives, subnormal and huge means, the empty digest) and register sets
(precisions 4 to 16, values past the 4-bit tailcut): the port's bytes
equal the JAX package's byte for byte, and each package decodes them
back to the same values. Exact, no tolerance.
"""

import numpy as np
import pytest

from veneur_tpu.ops import axiomhq as jaxiomhq
from veneur_tpu.protocol import gob as jgob
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.ops import axiomhq as taxiomhq
from veneur_tpu_torch.protocol import gob as tgob

DIGEST_CASES = [("digest", s) for s in range(8)]
SET_CASES = [("set", p) for p in (4, 7, 10, 12, 14, 16)]


def seeded_digest(seed):
    rng = np.random.default_rng(seed)
    if seed == 0:
        return np.array([]), np.array([]), 0.0, 0.0
    n = int(rng.integers(1, 120))
    means = np.sort(rng.normal(0.0, 10.0 ** int(rng.integers(-3, 9)), n))
    weights = rng.integers(1, 1000, n) / float(rng.integers(1, 8))
    if seed == 1:  # zero fields are omitted from gob structs
        means[0], weights[-1] = 0.0, 0.0
    if seed == 2:
        means[:3] = [-1e300, 5e-324, 1e300]
        means.sort()
    return means, weights, float(means.min()), float(means.max())


@pytest.mark.parametrize("kind,arg", DIGEST_CASES + SET_CASES,
                         ids=[f"{k}-{a}" for k, a in
                              DIGEST_CASES + SET_CASES])
def test_codecs_byte_identical_to_jax(kind, arg):
    if kind == "digest":
        means, weights, lo, hi = seeded_digest(arg)
        blob = tgob.encode_reference_digest(means, weights, 100.0, lo, hi)
        assert blob == jgob.encode_reference_digest(means, weights, 100.0,
                                                    lo, hi)
        got = tgob.decode_reference_digest(blob)
        assert got == jgob.decode_reference_digest(blob)
        assert got == (means.tolist(), weights.tolist(), 100.0, lo, hi)
        return
    rng = np.random.default_rng(arg)
    regs = rng.integers(0, 64 - arg, 1 << arg).astype(np.uint8)
    regs[rng.random(1 << arg) < 0.3] = 0
    blob = taxiomhq.encode_dense(regs, arg)
    assert blob == jaxiomhq.encode_dense(regs, arg)
    dec, p = taxiomhq.decode(blob)
    jdec, jp = jaxiomhq.decode(blob)
    assert p == jp == arg
    np.testing.assert_array_equal(dec, jdec)
    # the dense layout keeps registers within 15 of its base exactly
    base = blob[2]
    keep = (regs >= base) & (regs <= base + 15)
    np.testing.assert_array_equal(dec[keep], regs[keep])
    # our own VH layout is lossless and auto-detected beside axiomhq
    vh = tconvert.encode_hll(regs, arg)
    back, vp = tconvert.decode_hll(vh)
    assert vp == arg and np.array_equal(back, regs)
    np.testing.assert_array_equal(tconvert.decode_hll(blob)[0], dec)
