"""The port's accuracy sweep (``veneur_tpu_torch/analysis/tdigest_sweep.py``)
and the three ``ops/tdigest.py`` functions it needs, against the JAX
package's, on the CPU.

Tolerances:

* ``temp_buffer_size``: equal.
* ``merge_samples`` (the sort-based compress in both packages): weights
  and extrema equal, live means within rtol 1e-6 (float32 sums in
  another order).
* ``cdf`` on the same digest planes (gap slots included, empty rows
  NaN): within 1e-6.
* ``run_config``: the same samples (``np.random.default_rng(seed)`` in
  both); each row's digest mass within rtol 1e-6 of the JAX cell's and
  each per-row quantile within 0.02 x (max - min) of the row (the
  cross-rung envelope: the JAX CPU path is its XLA rung with the true
  arcsin, the port's the plain version of K2); the golden model's error
  equal; the port's max rank error within the documented envelope, 0.02
  (0.06 at compression 20), as the JAX tests assert of theirs.
* the vectorized rank error equals the JAX package's per-row loop
  exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from veneur_tpu.analysis import tdigest_sweep as jsweep
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch.analysis import tdigest_sweep as tsweep
from veneur_tpu_torch.ops import tdigest as ttd


def test_temp_buffer_size_equals_jax():
    for c in (1.0, 20.0, 50.0, 100.0, 200.0, 333.0, 925.0, 5000.0):
        assert ttd.temp_buffer_size(c) == jtd.temp_buffer_size(c)


@pytest.mark.parametrize("compression", [20.0, 100.0, 200.0])
def test_merge_samples_equals_jax(compression):
    rng = np.random.default_rng(int(compression))
    k = jtd.size_bound(compression)
    jd = jtd.init((48,), compression, k)
    td = ttd.init((48,), compression, k, device="cpu")
    for step in range(3):
        vals = (rng.lognormal(3.0, 1.0, (48, 300)) + 50 * step) \
            .astype(np.float32)
        wts = rng.integers(0, 3, (48, 300)).astype(np.float32)
        wts[5] = 0.0  # a row with nothing but padding
        jd = jtd.merge_samples(jd, jnp.asarray(vals), jnp.asarray(wts),
                               compression)
        td = ttd.merge_samples(td, torch.from_numpy(vals),
                               torch.from_numpy(wts), compression)
        jw = np.asarray(jd.weight)
        np.testing.assert_array_equal(td.weight.numpy(), jw)
        np.testing.assert_array_equal(td.min.numpy(), np.asarray(jd.min))
        np.testing.assert_array_equal(td.max.numpy(), np.asarray(jd.max))
        live = jw > 0
        np.testing.assert_allclose(td.mean.numpy()[live],
                                   np.asarray(jd.mean)[live], rtol=1e-6)
        assert np.all(np.isinf(td.mean.numpy()[~live]))


def test_cdf_equals_jax_on_gapped_planes():
    """The planes K2's plain version leaves (gap slots of weight 0 with
    gap-filled means) and empty rows, queried below the minimum, at
    the extrema, inside and above the maximum."""
    rng = np.random.default_rng(3)
    d = ttd.init((32,), 100.0, device="cpu")
    temp = ttd.init_temp(32, device="cpu")
    rows = torch.arange(30).repeat_interleave(64)
    vals = torch.from_numpy(rng.gamma(2.0, 10.0, 30 * 64)
                            .astype(np.float32))
    ttd.ingest_chunk(temp, rows, vals, torch.ones(30 * 64))
    d = ttd.drain_temp(d, temp)
    assert bool((d.weight[:30] == 0).any())  # gap slots present
    xs = np.concatenate([[-5.0, 0.0, 1e6], np.quantile(
        vals.numpy(), np.linspace(0.001, 0.999, 23))]).astype(np.float32)
    mins, maxs = d.min.numpy(), d.max.numpy()
    xs = np.concatenate([xs, mins[:3], maxs[:3]]).astype(np.float32)
    jd = jtd.TDigest(jnp.asarray(d.mean.numpy()),
                     jnp.asarray(d.weight.numpy()), jnp.asarray(mins),
                     jnp.asarray(maxs))
    want = np.asarray(jtd.cdf(jd, jnp.asarray(xs)))
    got = ttd.cdf(d, torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[30:]).all()
    np.testing.assert_allclose(got[:30], want[:30], atol=1e-6)


def test_rank_errors_equal_the_jax_loop():
    rng = np.random.default_rng(9)
    vals = np.round(rng.normal(100, 15, (6, 513))).astype(np.float32)
    pcts = np.concatenate([np.quantile(vals, jsweep.QS, axis=1).T[:, :5],
                           vals[:, :4]], axis=1).astype(np.float32)
    want = np.array([[jsweep.rank_err(np.sort(vals[r]), float(pcts[r, i]),
                                      q) for i, q in enumerate(jsweep.QS)]
                     for r in range(6)])
    got = tsweep.rank_errors(torch.from_numpy(vals),
                             torch.from_numpy(pcts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tsweep.rank_err(np.sort(vals[0]), float(pcts[0, 0]),
                           0.01) == want[0, 0]


def test_grid_and_samples_equal_jax():
    assert (tsweep.QS, tsweep.DISTS, tsweep.COMPRESSIONS, tsweep.PATHS,
            tsweep.DTYPES) == (jsweep.QS, jsweep.DISTS, jsweep.COMPRESSIONS,
                               jsweep.PATHS, jsweep.DTYPES)
    assert len(tsweep.grid()) == 180 and len(tsweep.grid(quick=True)) == 24
    for dist in tsweep.DISTS:
        np.testing.assert_array_equal(
            tsweep.sample_dist(dist, np.random.default_rng(4), (3, 64)),
            jsweep.sample_dist(dist, np.random.default_rng(4), (3, 64)))


CELLS = [("sorted_asc", 100.0, "binned16", "float32", 0.02),
         ("lognormal", 100.0, "binned16", "bfloat16", 0.02),
         ("pareto", 100.0, "fanin8", "float32", 0.02),
         ("normal", 20.0, "binned16", "float32", 0.06),
         ("pareto", 200.0, "binned4x4", "bfloat16", 0.02),
         ("uniform", 200.0, "chunks16", "float32", 0.02)]


@pytest.mark.parametrize("dist,compression,path,dtype,envelope", CELLS)
def test_run_config_matches_jax(monkeypatch, dist, compression, path,
                                dtype, envelope):
    kept = []
    real = jtd.quantile

    def keep(digest, qs):
        kept.append(digest)
        return real(digest, qs)

    monkeypatch.setattr(jtd, "quantile", keep)
    want = jsweep.run_config(dist, compression, path, dtype, rows=4,
                             n=1024, golden_rows=1)
    vals, digest = tsweep.cell_digest(dist, compression, path, dtype,
                                      rows=4, n=1024, device="cpu")
    got = tsweep.cell_record(dist, compression, path, dtype, vals, digest,
                             golden_rows=1)
    assert got == tsweep.run_config(dist, compression, path, dtype, rows=4,
                                    n=1024, golden_rows=1, device="cpu")
    jd = kept[-1]
    np.testing.assert_allclose(
        digest.weight.double().sum(-1).numpy(),
        np.asarray(jd.weight, np.float64).sum(-1), rtol=1e-6)
    v = vals.numpy()
    span = (v.max(1) - v.min(1)).astype(np.float64)[:, None]
    tq = ttd.quantile(digest, tsweep.QS).numpy().astype(np.float64)
    jq = np.asarray(real(jd, jnp.asarray(jsweep.QS, jnp.float32)),
                    np.float64)
    assert np.all(np.abs(tq - jq) <= 0.02 * span)
    assert got["golden_max_rank_err"] == want["golden_max_rank_err"]
    assert {k: got[k] for k in ("dist", "compression", "path", "dtype",
                                "rows", "n")} == \
        {k: want[k] for k in ("dist", "compression", "path", "dtype",
                              "rows", "n")}
    assert got["max_rank_err"] <= envelope, got
    assert want["max_rank_err"] <= envelope, want


def test_sweep_cli_writes_the_csv_and_summary(tmp_path, capsys):
    out = tmp_path / "sweep.csv"
    assert tsweep.main(["--quick", "--rows", "2", "--n", "256",
                        "--device", "cpu", "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("path,dtype,dist,compression,rows,n,")
    assert len(lines) == 1 + 24
    err = capsys.readouterr().err
    assert "| path | dtype | max rank err | worst cell | golden max |" in err
