"""The statsd TCP/TLS listener of the port's Server, against the JAX
package's Server, on the CPU.

Both rungs: the C++ listener (``native.NativeTLSReader``, with
``native_ingest``) and the Python one (``networking.start_statsd``,
``native_ingest: false``), over plain TCP and over TLS. The same seeded
DogStatsD lines go to a port ``Server(device="cpu")`` and a JAX
``Server`` over the same kind of listener; their flushed rows agree:
counters, gauges and counts exact, sums rtol 1e-6, percentiles within
0.02 x (max - min). Client authentication (``tls_authority_certificate``)
admits a certificate the authority signed and refuses an anonymous
client and one signed by another authority, before any line reaches the
store; a client that connects and sends nothing, and one that sends a
garbage handshake, do not stop the listener serving others.

The certificates under ``tests/data/torch_tls/`` (a CA, a server
certificate for localhost and 127.0.0.1, a client certificate, and one
signed by an untrusted CA) are valid until 2126. The native rung needs
g++ (its library builds on first use) and the runtime's libssl.
"""

import pathlib
import shutil
import socket
import ssl
import time

import numpy as np
import pytest

from veneur_tpu.config import Config as JConfig
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks import ChannelMetricSink as JChannelMetricSink
from veneur_tpu_torch import native
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

CERTS = pathlib.Path(__file__).resolve().parent / "data" / "torch_tls"
PCTS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum"]
RUNGS = ("native", "python")


def _cert(name: str) -> str:
    return str(CERTS / name)


def _lines(seed: int = 29) -> list:
    """Seeded DogStatsD lines: histograms over 16 series, counters at odd
    rates, gauges (the last value wins)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(16):
        for x in rng.gamma(2.0, 10.0, 24):
            lines.append(f"tls.h.{i}:{x:.4f}|h|#k:v{i % 3}")
    for i in range(8):
        lines += [f"tls.c.{i}:{int(n)}|c" for n in rng.integers(1, 9, 5)]
        lines.append(f"tls.c.{i}:2|c|@0.5")
        lines += [f"tls.g.{i}:{x:.3f}|g" for x in rng.normal(0, 5, 3)]
    return [ln.encode() for ln in lines]


LINES = _lines()


def _needs_native(rung: str, tls: bool = False) -> None:
    if rung != "native":
        return
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    if tls and not native.tls_available():
        pytest.skip("the runtime's libssl did not load")


def _config(cls, rung: str, tls: bool, auth: bool):
    kw = dict(statsd_listen_addresses=["tcp://127.0.0.1:0"],
              interval="86400s", percentiles=PCTS, aggregates=AGGS,
              hostname="h", native_ingest=rung == "native")
    if cls is Config:
        kw.update(store_initial_capacity=64, store_chunk=256)
    if tls:
        kw.update(tls_certificate=_cert("server.crt"),
                  tls_key=_cert("server.key"))
        if auth:
            kw["tls_authority_certificate"] = _cert("ca.crt")
    return cls(**kw)


def _start(rung: str, tls: bool, auth: bool = False, jax: bool = False):
    if jax:
        sink = JChannelMetricSink()
        server = JServer(_config(JConfig, rung, tls, auth),
                         metric_sinks=[sink])
    else:
        sink = ChannelMetricSink()
        server = Server(_config(Config, rung, tls, auth),
                        metric_sinks=[sink], device="cpu")
    server.start()
    return server, sink


def _client_ctx(cert: str = "") -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(_cert("ca.crt"))
    if cert:
        ctx.load_cert_chain(_cert(f"{cert}.crt"), _cert(f"{cert}.key"))
    return ctx


def _connect(addr, tls: bool, cert: str = ""):
    raw = socket.create_connection(addr, timeout=5)
    if not tls:
        return raw
    return _client_ctx(cert).wrap_socket(raw, server_hostname="localhost")


def _send(addr, tls: bool, payload: bytes, cert: str = "") -> None:
    conn = _connect(addr, tls, cert)
    conn.sendall(payload)
    conn.close()


def _wait_processed(server, want: int, timeout: float = 20.0) -> int:
    deadline = time.time() + timeout
    while time.time() < deadline and server.store.processed < want:
        time.sleep(0.02)
    return server.store.processed


def _run(rung: str, tls: bool, jax: bool = False) -> dict:
    """Every line over one connection, one flush: the rows by (name,
    tags, type)."""
    server, sink = _start(rung, tls, jax=jax)
    try:
        if not jax:
            assert [r for _, r, _ in server.listeners] == [rung]
        _send(server.statsd_addrs[0], tls, b"\n".join(LINES) + b"\n")
        assert _wait_processed(server, len(LINES)) == len(LINES)
        server.flush()
        rows = sink.get_flush(timeout=30)
    finally:
        server.shutdown()
    return {(m.name, tuple(m.tags), m.type.value): m.value for m in rows}


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX Server's rows over plain TCP and over TLS."""
    return {tls: _run("python", tls, jax=True) for tls in (False, True)}


@pytest.mark.parametrize("tls", [False, True], ids=["tcp", "tls"])
@pytest.mark.parametrize("rung", RUNGS)
def test_rows_match_jax_server(rung, tls, jax_rows):
    _needs_native(rung, tls)
    got, want = _run(rung, tls), jax_rows[tls]
    assert set(got) == set(want)
    for key, value in want.items():
        name, tags, _ = key
        base, _, suffix = name.rpartition(".")
        if suffix == "sum":
            np.testing.assert_allclose(got[key], value, rtol=1e-6)
        elif suffix.endswith("percentile"):
            lo = want[(f"{base}.min", tags, "gauge")]
            hi = want[(f"{base}.max", tags, "gauge")]
            assert abs(got[key] - value) <= 0.02 * (hi - lo) + 1e-6, key
        else:
            assert got[key] == value, key


def _assert_refused(server, cert: str = "") -> None:
    """A client the server cannot authenticate gets no line into the
    store, and its connection dies (an alert or EOF)."""
    died = False
    try:
        conn = _connect(server.statsd_addrs[0], True, cert)
        conn.sendall(b"tls.refused:1|c\n")
        conn.settimeout(5)
        died = conn.recv(1) == b""
        conn.close()
    except (ssl.SSLError, OSError):
        died = True
    assert died, "the connection stayed open without authentication"
    time.sleep(0.3)
    assert server.store.processed == 0


@pytest.mark.parametrize("rung", RUNGS)
def test_client_auth(rung):
    """A certificate the authority signed gets through; an anonymous
    client and one signed by an untrusted authority do not, and the C++
    listener counts their failed handshakes."""
    _needs_native(rung, tls=True)
    server, _ = _start(rung, tls=True, auth=True)
    try:
        _assert_refused(server)
        _assert_refused(server, cert="rogue")
        _send(server.statsd_addrs[0], True, b"tls.auth:1|c\n",
              cert="client")
        assert _wait_processed(server, 1) == 1
        if rung == "native":
            reader = server.native_readers[0]
            assert reader.handshake_failures() == 2
            assert reader.conns() == 3 and reader.drops() == 0
    finally:
        server.shutdown()


@pytest.mark.parametrize("rung", RUNGS)
def test_silent_client_does_not_block_handshakes(rung):
    """A client that connects and sends nothing holds only its own
    handshake: another client gets straight through."""
    _needs_native(rung, tls=True)
    server, _ = _start(rung, tls=True)
    try:
        silent = socket.create_connection(server.statsd_addrs[0], timeout=5)
        try:
            t0 = time.perf_counter()
            _send(server.statsd_addrs[0], True, b"tls.past_silent:1|c\n")
            assert time.perf_counter() - t0 < 5.0
            assert _wait_processed(server, 1) == 1
        finally:
            silent.close()
    finally:
        server.shutdown()


@pytest.mark.parametrize("rung", RUNGS)
def test_garbage_handshake_keeps_serving(rung):
    """Junk in place of a ClientHello costs its connection only."""
    _needs_native(rung, tls=True)
    server, _ = _start(rung, tls=True)
    try:
        for _ in range(3):
            raw = socket.create_connection(server.statsd_addrs[0],
                                           timeout=5)
            raw.sendall(b"\x16\x03\x01\x00\x04junk")
            raw.close()
        _send(server.statsd_addrs[0], True, b"tls.after_garbage:1|c\n")
        assert _wait_processed(server, 1) == 1
    finally:
        server.shutdown()


def test_long_line_closes_the_connection():
    """A line past metric_max_length closes its connection on the Python
    rung (server.go:920-983); the listener keeps serving."""
    cfg = Config(statsd_listen_addresses=["tcp://127.0.0.1:0"],
                 interval="86400s", hostname="h", native_ingest=False,
                 metric_max_length=64)
    server = Server(cfg, metric_sinks=[ChannelMetricSink()], device="cpu")
    server.start()
    try:
        conn = _connect(server.statsd_addrs[0], False)
        conn.sendall(b"x" * 200)
        conn.settimeout(5)
        assert conn.recv(1) == b""
        conn.close()
        _send(server.statsd_addrs[0], False, b"tcp.after_long:1|c\n")
        assert _wait_processed(server, 1) == 1
    finally:
        server.shutdown()
