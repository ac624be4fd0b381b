"""The SIGUSR2 upgrade of the port's binaries (``cli/upgrade.py``), the
cases of JAX ``tests/test_upgrade.py`` and ``tests/test_upgrade_e2e.py``
on the port:

* the handshake against real ``python -c`` stub processes and inherited
  fds (no torch import a stub);
* the CLI wiring with the Server and the spawn injected, real signals to
  the main thread's handlers;
* the overlap the upgrade needs: two port OpsServers on one fixed port
  (a plain ThreadingHTTPServer there raises EADDRINUSE, the fault the
  port had before its HTTP listeners bound with SO_REUSEPORT);
* one real two-generation handoff of ``python -m
  veneur_tpu_torch.cli.server --device cpu`` and one of
  ``python -m veneur_tpu_torch.cli.proxy``.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

from veneur_tpu_torch.cli import upgrade


_REPO = os.path.abspath(upgrade.__file__).rsplit(os.sep + "veneur_tpu_torch",
                                                 1)[0]


def _stub(body: str):
    """argv for a child that runs ``body`` with the port importable."""
    return [sys.executable, "-c",
            "import sys; sys.path.insert(0, %r); %s" % (_REPO, body)]


READY_BODY = ("from veneur_tpu_torch.cli import upgrade; "
              "assert upgrade.notify_ready()")


def test_notify_ready_writes_one_byte_and_clears_env(monkeypatch):
    r, w = os.pipe()
    monkeypatch.setenv(upgrade.READY_ENV, str(w))
    assert upgrade.notify_ready()
    assert os.read(r, 2) == b"1"
    os.close(r)
    # fd is closed and the env var consumed: a second call is a no-op
    assert upgrade.READY_ENV not in os.environ
    assert not upgrade.notify_ready()


def test_notify_ready_without_env_is_noop():
    os.environ.pop(upgrade.READY_ENV, None)
    assert not upgrade.notify_ready()


def test_notify_ready_survives_dead_parent(monkeypatch):
    r, w = os.pipe()
    os.close(r)  # parent's read end gone → EPIPE on write
    monkeypatch.setenv(upgrade.READY_ENV, str(w))
    assert not upgrade.notify_ready()
    os.close(w)


def test_spawn_replacement_ready():
    child = upgrade.spawn_replacement(
        _stub(READY_BODY), ready_timeout=60.0)
    assert child is not None
    assert child.wait(timeout=30) == 0


def test_spawn_replacement_child_exits_early():
    argv = [sys.executable, "-c", "import sys; sys.exit(3)"]
    assert upgrade.spawn_replacement(argv, ready_timeout=30.0) is None


def test_spawn_replacement_timeout_kills_child():
    argv = [sys.executable, "-c", "import time; time.sleep(600)"]
    t0 = time.monotonic()
    child_seen = {}
    real_popen = upgrade.subprocess.Popen

    def spy(*a, **k):
        p = real_popen(*a, **k)
        child_seen["p"] = p
        return p

    assert upgrade.spawn_replacement(argv, ready_timeout=1.5,
                                     popen=spy) is None
    assert time.monotonic() - t0 < 30
    # the non-ready child was killed, not leaked
    assert child_seen["p"].poll() is not None


def test_spawn_replacement_fd_closed_without_byte():
    # child closes the readiness fd without writing — it can never
    # become ready, so the parent must kill it and keep serving
    body = ("import os, time; "
            "os.close(int(os.environ['VENEUR_READY_FD'])); "
            "time.sleep(600)")
    argv = [sys.executable, "-c", body]
    child_seen = {}
    real_popen = upgrade.subprocess.Popen

    def spy(*a, **k):
        p = real_popen(*a, **k)
        child_seen["p"] = p
        return p

    t0 = time.monotonic()
    assert upgrade.spawn_replacement(argv, ready_timeout=60.0,
                                     popen=spy) is None
    assert time.monotonic() - t0 < 30  # did not wait for the timeout
    assert child_seen["p"].poll() is not None


def test_spawn_failure_returns_none():
    def boom(*a, **k):
        raise OSError("no such binary")

    assert upgrade.spawn_replacement(["/nonexistent"], popen=boom) is None


def test_replacement_argv_reexecs_same_interpreter():
    argv = upgrade.replacement_argv("/etc/veneur.yaml",
                                    "veneur_tpu_torch.cli.server")
    assert argv[0] == sys.executable
    assert argv[1:] == ["-m", "veneur_tpu_torch.cli.server",
                        "-f", "/etc/veneur.yaml"]


def test_replacement_argv_prefers_recorded_startup_argv():
    """An upgrade re-execs the argv the operator actually launched —
    including flags beyond -f — when the CLI main recorded it."""
    try:
        upgrade.record_startup_argv(
            "veneur_tpu_torch.cli.server",
            ["-f", "/etc/veneur.yaml", "--future-flag"])
        argv = upgrade.replacement_argv("/etc/veneur.yaml",
                                        "veneur_tpu_torch.cli.server")
        assert argv == [sys.executable, "-m", "veneur_tpu_torch.cli.server",
                        "-f", "/etc/veneur.yaml", "--future-flag"]
    finally:
        upgrade._reset_state_for_tests()
    # without a recording, the constructed form is the fallback
    argv = upgrade.replacement_argv("/etc/veneur.yaml",
                                    "veneur_tpu_torch.cli.server")
    assert argv == [sys.executable, "-m", "veneur_tpu_torch.cli.server",
                    "-f", "/etc/veneur.yaml"]


def test_request_shutdown_wins_handoff_race(monkeypatch):
    """The handoff race: a shutdown request landing after the
    replacement is ready but before the handoff's done.set() must still
    stop the replacement. request_shutdown marks the stop under the
    same lock the handoff checks, so the interleaving is closed."""
    upgrade._reset_state_for_tests()
    done = threading.Event()
    killed = []

    class FakeChild:
        pid = 778

        def kill(self):
            killed.append(self.pid)

        def wait(self, timeout=None):
            return 0

    def spawn_then_shutdown_request(argv, **kw):
        # the operator's SIGTERM lands while the handoff thread holds a
        # ready child but before it could set done: request_shutdown
        # (not a bare done.set()) records operator intent atomically
        upgrade.request_shutdown(done)
        return FakeChild()

    monkeypatch.setattr(upgrade, "spawn_replacement",
                        spawn_then_shutdown_request)
    h = upgrade.make_sigusr2_handler("/cfg.yaml", "veneur_tpu_torch.cli.server",
                                     done)
    try:
        h(signal.SIGUSR2, None)
        deadline = time.monotonic() + 5
        while not killed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert killed == [778]
    finally:
        upgrade._reset_state_for_tests()


def test_reap_unfinished_replacement_kills_starting_child():
    """A shutdown arriving while the replacement is mid-startup (the
    possibly minutes-long readiness wait): the CLI main's exit path
    reaps the recorded not-yet-handed-off child."""
    upgrade._reset_state_for_tests()
    done = threading.Event()
    argv = [sys.executable, "-c", "import time; time.sleep(600)"]
    result = {}

    def run_spawn():
        result["child"] = upgrade.spawn_replacement(argv, ready_timeout=60.0)

    t = threading.Thread(target=run_spawn)
    t.start()
    try:
        # wait until the child is recorded as pending
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with upgrade._state_lock:
                if upgrade._pending_replacement is not None:
                    break
            time.sleep(0.01)
        with upgrade._state_lock:
            assert upgrade._pending_replacement is not None
        # operator shutdown: main's exit path reaps the orphan
        upgrade.request_shutdown(done)
        upgrade.reap_unfinished_replacement()
        t.join(timeout=30)
        assert not t.is_alive()
        # the spawn wait observed the killed child and reported failure
        assert result["child"] is None
        with upgrade._state_lock:
            assert upgrade._pending_replacement is None
    finally:
        upgrade._reset_state_for_tests()
        t.join(timeout=5)


def test_spawn_refused_after_shutdown_requested():
    """SIGUSR2 racing an already-requested shutdown must not upgrade."""
    upgrade._reset_state_for_tests()
    done = threading.Event()
    upgrade.request_shutdown(done)
    try:
        argv = [sys.executable, "-c", "import time; time.sleep(600)"]
        t0 = time.monotonic()
        assert upgrade.spawn_replacement(argv, ready_timeout=60.0) is None
        assert time.monotonic() - t0 < 30  # no readiness wait happened
    finally:
        upgrade._reset_state_for_tests()


def test_usr2_coalesces_and_ignores_when_draining(monkeypatch):
    """Overlapping SIGUSR2s run one upgrade, and a signal arriving
    after the drain began must not spawn a second replacement (two
    would co-serve the ports forever once the parent exits)."""
    done = threading.Event()
    started = threading.Event()
    release = threading.Event()
    spawned = []

    def slow_spawn(argv, **kw):
        spawned.append(argv)
        started.set()
        release.wait(10)
        return object()

    monkeypatch.setattr(upgrade, "spawn_replacement", slow_spawn)
    h = upgrade.make_sigusr2_handler("/cfg.yaml", "veneur_tpu_torch.cli.server",
                                     done)
    h(signal.SIGUSR2, None)
    assert started.wait(5)
    h(signal.SIGUSR2, None)  # in-flight: coalesces, no second spawn
    release.set()
    deadline = time.monotonic() + 5
    while not done.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert done.is_set()
    time.sleep(0.2)
    assert len(spawned) == 1
    h(signal.SIGUSR2, None)  # already draining: ignored
    time.sleep(0.3)
    assert len(spawned) == 1


def test_shutdown_during_upgrade_stops_replacement(monkeypatch):
    """SIGTERM while the replacement is still starting means STOP the
    service: the replacement must not outlive this generation."""
    done = threading.Event()
    killed = []

    class FakeChild:
        pid = 777

        def kill(self):
            killed.append(self.pid)

        def wait(self, timeout=None):
            return 0

    def spawn_then_term(argv, **kw):
        done.set()  # SIGTERM lands while spawn_replacement is blocked
        return FakeChild()

    monkeypatch.setattr(upgrade, "spawn_replacement", spawn_then_term)
    h = upgrade.make_sigusr2_handler("/cfg.yaml", "veneur_tpu_torch.cli.server",
                                     done)
    h(signal.SIGUSR2, None)
    deadline = time.monotonic() + 5
    while not killed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert killed == [777]


def test_warn_for_stream_addr_parses_grpc_formats(monkeypatch, caplog):
    """The gRPC-style addr probe: a live listener on the port warns,
    and odd inputs (no port, v6 wildcard on any host) never raise."""
    import logging

    from veneur_tpu_torch import networking

    first = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    first.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    first.bind(("127.0.0.1", 0))
    first.listen(1)
    port = first.getsockname()[1]
    try:
        monkeypatch.delenv(upgrade.READY_ENV, raising=False)
        with caplog.at_level(logging.WARNING, logger="veneur.networking"):
            networking.warn_for_stream_addr(f"127.0.0.1:{port}")
        assert any("already being served" in r.getMessage()
                   for r in caplog.records)
    finally:
        first.close()
    # best-effort on everything else: no exceptions
    networking.warn_for_stream_addr("[::]:0")
    networking.warn_for_stream_addr("localhost")
    networking.warn_for_stream_addr("[::]:notaport")


def test_overlap_probe_warns_on_second_instance(monkeypatch, caplog):
    import logging

    from veneur_tpu_torch import networking

    # bind exactly as a real veneur UDP listener does (new_udp_socket:
    # REUSEADDR + REUSEPORT) — a REUSEADDR probe would bind alongside
    # this and never warn
    first = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    first.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    first.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    first.bind(("127.0.0.1", 0))
    port = first.getsockname()[1]
    try:
        monkeypatch.delenv(upgrade.READY_ENV, raising=False)
        with caplog.at_level(logging.WARNING, logger="veneur.networking"):
            networking.warn_if_port_already_served(
                socket.AF_INET, socket.SOCK_DGRAM, "127.0.0.1", port)
        assert any("already being served" in r.getMessage()
                   for r in caplog.records)
        # an upgrade replacement overlaps by design: no warning
        caplog.clear()
        monkeypatch.setenv(upgrade.READY_ENV, "7")
        with caplog.at_level(logging.WARNING, logger="veneur.networking"):
            networking.warn_if_port_already_served(
                socket.AF_INET, socket.SOCK_DGRAM, "127.0.0.1", port)
        assert not caplog.records
    finally:
        first.close()
    # a free port is quiet too
    caplog.clear()
    monkeypatch.delenv(upgrade.READY_ENV, raising=False)
    with caplog.at_level(logging.WARNING, logger="veneur.networking"):
        networking.warn_if_port_already_served(
            socket.AF_INET, socket.SOCK_DGRAM, "127.0.0.1", port)
    assert not caplog.records


class TestServerCLIWiring:
    """main() wires SIGUSR2 → spawn_replacement → drain: exercised with
    the Server and spawn injected, signals delivered for real to the
    pytest main-thread handlers."""

    def _run_main_with_fakes(self, monkeypatch, tmp_path, spawn_result):
        from veneur_tpu_torch.cli import server as cli_server

        cfg = tmp_path / "v.yaml"
        cfg.write_text(
            "statsd_listen_addresses: ['udp://127.0.0.1:0']\n"
            "interval: '86400s'\n")

        events = []

        class FakeServer:
            listeners = []
            ssf_listeners = []

            def __init__(self, config, device=None, config_sinks=None):
                events.append(("init", device))

            def start(self):
                events.append("start")

            def shutdown(self):
                events.append("shutdown")

        spawned = []

        def fake_spawn(argv, **kw):
            spawned.append(argv)
            return spawn_result

        monkeypatch.setattr(cli_server, "Server", FakeServer)
        monkeypatch.setattr(cli_server.upgrade, "spawn_replacement",
                            fake_spawn)

        rc = {}

        def run():
            rc["rc"] = cli_server.main(["-f", str(cfg), "--device", "cpu"])

        # signal.signal requires the main thread: deliver SIGUSR2 from a
        # helper thread once main() has installed its handlers and is
        # blocked in done.wait(); run main() right here.
        def kicker():
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and "start" not in events:
                time.sleep(0.01)
            os.kill(os.getpid(), signal.SIGUSR2)
            if spawn_result is None:
                # failed upgrade must NOT drain; unblock with TERM
                time.sleep(1.0)
                os.kill(os.getpid(), signal.SIGTERM)

        saved = {s: signal.getsignal(s)
                 for s in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP,
                           signal.SIGUSR2)}
        t = threading.Thread(target=kicker)
        t.start()
        try:
            run()
        finally:
            t.join(timeout=15)
            for s, h in saved.items():
                signal.signal(s, h)
        return rc["rc"], events, spawned

    def test_usr2_spawns_and_drains(self, monkeypatch, tmp_path):
        class FakeChild:
            pid = 12345

        rc, events, spawned = self._run_main_with_fakes(
            monkeypatch, tmp_path, FakeChild())
        assert rc == 0
        assert events == [("init", "cpu"), "start", "shutdown"]
        (argv,) = spawned
        # the replacement re-execs the recorded argv: the same device
        assert argv == [sys.executable, "-m", "veneur_tpu_torch.cli.server",
                        "-f", argv[4], "--device", "cpu"]

    def test_sighup_reloads_from_the_file(self, monkeypatch, tmp_path):
        """SIGHUP re-reads the file on a thread and hands it to
        Server.reload; the process keeps serving until SIGTERM."""
        from veneur_tpu_torch.cli import server as cli_server

        cfg = tmp_path / "v.yaml"
        cfg.write_text("interval: '86400s'\npercentiles: [0.5]\n")
        reloaded = []

        class FakeServer:
            listeners = []
            ssf_listeners = []

            def __init__(self, config, device=None, config_sinks=None):
                pass

            def start(self):
                cfg.write_text("interval: '7s'\npercentiles: [0.9]\n")
                os.kill(os.getpid(), signal.SIGHUP)

            def reload(self, config):
                reloaded.append((config.interval, config.percentiles))
                os.kill(os.getpid(), signal.SIGTERM)

            def shutdown(self):
                pass

        monkeypatch.setattr(cli_server, "Server", FakeServer)
        saved = {s: signal.getsignal(s)
                 for s in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP,
                           signal.SIGUSR2)}
        try:
            assert cli_server.main(["-f", str(cfg), "--device", "cpu"]) == 0
        finally:
            for s, h in saved.items():
                signal.signal(s, h)
        assert reloaded == [("7s", [0.9])]

    def test_failed_upgrade_keeps_serving(self, monkeypatch, tmp_path):
        rc, events, spawned = self._run_main_with_fakes(
            monkeypatch, tmp_path, None)
        # drained only by the later SIGTERM, not by the failed upgrade
        assert rc == 0
        assert events == [("init", "cpu"), "start", "shutdown"]
        assert len(spawned) == 1


def test_reuseport_overlap_two_http_generations():
    """Two OpsServer generations co-bind one TCP port (the property the
    upgrade relies on), and both answer /healthcheck; a plain
    ThreadingHTTPServer, which the port's OpsServer was, cannot bind
    beside them."""
    import errno
    import urllib.request
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import pytest

    from veneur_tpu_torch.httpserv import OpsServer

    old = OpsServer(addr="127.0.0.1:0")
    old.start()
    try:
        port = old.port
        with pytest.raises(OSError) as err:
            ThreadingHTTPServer(("127.0.0.1", port), BaseHTTPRequestHandler)
        assert err.value.errno == errno.EADDRINUSE
        new = OpsServer(addr=f"127.0.0.1:{port}")
        new.start()  # would raise EADDRINUSE without SO_REUSEPORT
        try:
            for _ in range(4):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthcheck",
                        timeout=5) as resp:
                    assert resp.status == 200
        finally:
            new.stop()
        # old generation still serving after the new one drains away
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthcheck", timeout=5) as resp:
            assert resp.status == 200
    finally:
        old.stop()


# -- real generations ---------------------------------------------------------

STARTUP_TIMEOUT = 180.0


def _free_port(kind) -> int:
    """A free port for a config both generations read (the replacement
    re-execs the same file, so its ports are fixed; the close-to-bind
    window is milliseconds)."""
    s = socket.socket(socket.AF_INET, kind)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port: int, path: str, timeout: float = 2.0):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return resp.status, resp.read()


def _wait_health(port: int, deadline: float) -> bool:
    while time.monotonic() < deadline:
        try:
            if _get(port, "/healthcheck")[0] == 200:
                return True
        except OSError:
            time.sleep(0.25)
    return False


def _replacement_pids(pattern: str):
    out = subprocess.run(["pgrep", "-f", pattern], capture_output=True,
                         text=True)
    return [int(p) for p in out.stdout.split()]


def _stop(pid: int) -> None:
    try:
        os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return
            time.sleep(0.25)
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _handoff(tmp_path, module, cfg_text, http, after=None):
    """Run generation 1 of ``module`` on ``cfg_text``, SIGUSR2 it, and
    check that it exits 0 once generation 2 serves ``http``; ``after``
    then runs against generation 2. Returns generation 1's log."""
    cfg = tmp_path / "gen.yaml"
    cfg.write_text(cfg_text)
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop(upgrade.READY_ENV, None)
    argv = [sys.executable, "-m", module, "-f", str(cfg)]
    if module.endswith("server"):
        argv += ["--device", "cpu"]
    pattern = f"{module} -f {cfg}"
    log1 = open(tmp_path / "gen1.log", "wb")
    gen1 = subprocess.Popen(argv, env=env, stdout=log1,
                            stderr=subprocess.STDOUT)
    gen2 = []
    try:
        assert _wait_health(http, time.monotonic() + STARTUP_TIMEOUT), \
            "generation 1 never became healthy"
        gen1.send_signal(signal.SIGUSR2)
        assert gen1.wait(timeout=STARTUP_TIMEOUT) == 0
        assert _wait_health(http, time.monotonic() + 30), \
            "no generation serving after generation 1 drained"
        gen2 = [p for p in _replacement_pids(pattern) if p != gen1.pid]
        assert gen2, "the replacement process is not running"
        if after is not None:
            after()
    finally:
        log1.close()
        if gen1.poll() is None:
            gen1.kill()
            gen1.wait(timeout=10)
        for pid in gen2 or _replacement_pids(pattern):
            _stop(pid)
    text = (tmp_path / "gen1.log").read_text()
    assert "replacement pid" in text and "is serving" in text
    assert "draining this generation" in text
    return text


def test_sigusr2_full_handoff_of_the_server(tmp_path):
    """Generation 1 of the port's server CLI on the CPU takes a counter,
    SIGUSR2 starts generation 2 on the same file and ports, generation 1
    drains and exits 0, and generation 2 aggregates what is sent after
    (its /debug/vars counts it)."""
    import json

    udp = _free_port(socket.SOCK_DGRAM)
    http = _free_port(socket.SOCK_STREAM)
    cfg = (f"statsd_listen_addresses: ['udp://127.0.0.1:{udp}']\n"
           f"http_address: '127.0.0.1:{http}'\n"
           "interval: '600s'\n"
           "aggregates: ['count']\n"
           "num_readers: 1\n"
           "store_initial_capacity: 64\n"
           "store_chunk: 128\n")
    sender = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def after():
        for _ in range(5):
            sender.sendto(b"upgrade.after:1|c", ("127.0.0.1", udp))
        deadline = time.monotonic() + 30
        got = 0
        while time.monotonic() < deadline and not got:
            try:
                body = json.loads(_get(http, "/debug/vars")[1])
                got = body["store"]["processed_this_interval"]
            except OSError:
                pass
            time.sleep(0.25)
        assert got, "generation 2 never aggregated the datagrams"

    try:
        _handoff(tmp_path, "veneur_tpu_torch.cli.server", cfg, http, after)
    finally:
        sender.close()


def test_sigusr2_full_handoff_of_the_proxy(tmp_path):
    """The proxy binary on the same protocol: generation 2 binds the same
    HTTP port beside generation 1, which exits 0 once it is ready."""
    http = _free_port(socket.SOCK_STREAM)
    cfg = (f"http_address: '127.0.0.1:{http}'\n"
           "forward_address: '127.0.0.1:1'\n")
    _handoff(tmp_path, "veneur_tpu_torch.cli.proxy", cfg, http)
