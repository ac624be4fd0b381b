"""The port stands alone: veneur_tpu_torch and the scripts beside it
(chip_smoke.py, chip_stages.py) import neither jax nor anything of
veneur_tpu, nor protobuf (the port decodes SSF and MetricLists with its
own codecs), and open no path under veneur_tpu/ (the port builds and
loads its own native library). ``grpc`` is imported only inside the
functions of the gRPC lanes and the proxy, never at module import: a
gRPC key without grpcio raises at config time.

An AST scan covers every import statement and every string that is not
a docstring; a subprocess with ``jax``, ``veneur_tpu``,
``google.protobuf`` and ``grpc`` blocked from import then imports every
module of the port and both scripts, so an import hidden behind a string
or a call would fail there too, and a module-level ``import grpc`` with
it.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "veneur_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "veneur_tpu", "google.protobuf")
# blocked from import in the subprocess: the forbidden packages, and
# grpc, which only the gRPC lanes' functions import
BLOCKED = FORBIDDEN + ("grpc",)
SCRIPTS = ("chip_smoke", "chip_stages")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / f"{s}.py" for s in SCRIPTS]


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods + list(SCRIPTS)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_jax_or_reference_imports():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mod = node.module or ""
                if _forbidden(mod) or any(_forbidden(f"{mod}.{a.name}")
                                          for a in node.names):
                    bad.append((path.name, mod))
    assert not bad, bad
    assert len(_sources()) > 20


def _strings(tree):
    """Every string constant of a module that is not a docstring."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and id(node) not in docs]


def test_no_path_under_the_reference_package():
    """No code string names a path under veneur_tpu/ (a way to load the
    JAX package's native library or sources); chip_smoke.py's kernel
    summary alone names the TPU kernels the CUDA kernels replace."""
    pattern = re.compile(r"(^|[/\\])veneur_tpu([/\\]|$)")
    found = [(path.name, node.value) for path in _sources()
             for node in _strings(ast.parse(path.read_text(), str(path)))
             if pattern.search(node.value)]
    assert found == [("chip_smoke.py", "veneur_tpu/ops/tdigest_pallas.py:")]


def test_ingest_modules_are_covered():
    assert {"veneur_tpu_torch.native", "veneur_tpu_torch.ingest",
            "veneur_tpu_torch.ingest.lanes", "veneur_tpu_torch.ingest.counters",
            "veneur_tpu_torch.ingest.recvmmsg"} <= set(_modules())
    assert {"veneur_tpu_torch.protocol.ssf", "veneur_tpu_torch.protocol.wire",
            "veneur_tpu_torch.sinks.ssfmetrics"} <= set(_modules())


def test_egress_modules_are_covered():
    """The flush-egress slice's modules are scanned and imported too, and
    its C++ source is the port's own copy beside its bindings."""
    assert {"veneur_tpu_torch.native.egress", "veneur_tpu_torch.core.columnar",
            "veneur_tpu_torch.core.pipeline", "veneur_tpu_torch.sinks.datadog",
            "veneur_tpu_torch.plugins", "veneur_tpu_torch.plugins.localfile",
            "veneur_tpu_torch.plugins.csv_encode"} <= set(_modules())
    assert (PKG / "native" / "veneur_egress.cpp").is_file()


def test_native_forward_modules_are_covered():
    """The packed binary forward's modules (the MetricList codec, the
    on-card pack, the framed-TCP lane) are scanned and imported too."""
    assert {"veneur_tpu_torch.protocol.mlist", "veneur_tpu_torch.core.slab",
            "veneur_tpu_torch.forward.native_transport"} <= set(_modules())


def test_crash_safe_state_modules_are_covered():
    """The checkpoint and compute-ladder slice's modules (persist/, the
    compute breaker, fault injection) are scanned and imported too."""
    assert {"veneur_tpu_torch.persist", "veneur_tpu_torch.persist.format",
            "veneur_tpu_torch.persist.checkpoint",
            "veneur_tpu_torch.resilience.compute",
            "veneur_tpu_torch.resilience.faults"} <= set(_modules())


def test_digest_storage_modules_are_covered():
    """The slab and tiered digest stores are scanned and imported too."""
    assert {"veneur_tpu_torch.core.slab", "veneur_tpu_torch.core.tiered",
            "veneur_tpu_torch.core.bucketing"} <= set(_modules())


def test_mesh_modules_are_covered():
    """The mesh-sharded global tier (parallel/, the fleet router, the
    proxy's ring, the mesh store) is scanned and imported too."""
    assert {"veneur_tpu_torch.parallel", "veneur_tpu_torch.parallel.mesh",
            "veneur_tpu_torch.parallel.collectives",
            "veneur_tpu_torch.parallel.global_agg",
            "veneur_tpu_torch.fleet", "veneur_tpu_torch.fleet.router",
            "veneur_tpu_torch.proxy", "veneur_tpu_torch.proxy.consistent",
            "veneur_tpu_torch.core.mesh_store"} <= set(_modules())


def test_grpc_and_proxy_modules_are_covered():
    """The gRPC forward and import, discovery, the proxy tier and its
    binary are scanned and imported too; grpc is imported inside
    functions only (no module-level import statement names it)."""
    assert {"veneur_tpu_torch.forward.grpc_forward",
            "veneur_tpu_torch.discovery", "veneur_tpu_torch.proxy.proxy",
            "veneur_tpu_torch.proxy.grpc_proxy",
            "veneur_tpu_torch.cli.proxy"} <= set(_modules())
    top = []
    for path in _sources():
        for node in ast.parse(path.read_text(), str(path)).body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            top += [(path.name, n) for n in names
                    if n == "grpc" or n.startswith("grpc.")]
    assert not top, top


def test_fleet_ha_modules_are_covered():
    """The elastic and HA global tier (the handoff, the standby, the
    lease, the mesh tiered store) is scanned and imported too."""
    assert {"veneur_tpu_torch.fleet.handoff",
            "veneur_tpu_torch.fleet.standby",
            "veneur_tpu_torch.fleet.mesh_tiered",
            "veneur_tpu_torch.discovery.lease"} <= set(_modules())


def test_obs_modules_are_covered():
    """The interval timeline and the flush's self-trace (trace/, obs/,
    debug.py) are scanned and imported too."""
    assert {"veneur_tpu_torch.trace", "veneur_tpu_torch.trace.samples",
            "veneur_tpu_torch.trace.client", "veneur_tpu_torch.trace.backend",
            "veneur_tpu_torch.trace.metrics", "veneur_tpu_torch.obs",
            "veneur_tpu_torch.obs.recorder", "veneur_tpu_torch.obs.timeline",
            "veneur_tpu_torch.obs.kernels",
            "veneur_tpu_torch.debug"} <= set(_modules())


def test_fleet_trace_modules_are_covered():
    """The fleet trace plane (the cross-hop context, the fleet view) and
    the crash surface are scanned and imported too."""
    assert {"veneur_tpu_torch.obs.tracectx", "veneur_tpu_torch.obs.fleet",
            "veneur_tpu_torch.crash"} <= set(_modules())


def test_sink_and_listener_modules_are_covered():
    """The remaining sinks, the S3 plugin and the sink factory are scanned
    and imported too; the TCP/TLS listener lives in the modules covered
    above (networking, native, server)."""
    assert {"veneur_tpu_torch.sinks.signalfx", "veneur_tpu_torch.sinks.kafka",
            "veneur_tpu_torch.sinks.kafka_wire",
            "veneur_tpu_torch.sinks.lightstep",
            "veneur_tpu_torch.sinks.grpsink",
            "veneur_tpu_torch.sinks.falconer",
            "veneur_tpu_torch.sinks.factory",
            "veneur_tpu_torch.plugins.s3"} <= set(_modules())


def test_lifecycle_modules_are_covered():
    """The upgrade choreography, the client CLIs and the OpenTracing
    layer are scanned and imported too; the two clients do no device
    work, so they import with torch blocked as well."""
    assert {"veneur_tpu_torch.cli.upgrade", "veneur_tpu_torch.cli.emit",
            "veneur_tpu_torch.cli.prometheus", "veneur_tpu_torch.cli.server",
            "veneur_tpu_torch.trace.opentracing"} <= set(_modules())
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import veneur_tpu_torch.cli.emit, "
            "veneur_tpu_torch.cli.prometheus\n"
            "print('clients imported')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clients imported" in out.stdout


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in list(sys.modules):\n"
        "    if any(name == b or name.startswith(b + '.')\n"
        "           for b in {blocked!r}):\n"
        "        del sys.modules[name]\n"
        "for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        "for mod in {mods!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('imported', len({mods!r}))\n"
    ).format(blocked=BLOCKED, mods=_modules())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(_modules())}" in out.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device: chip_smoke exits non-zero and prints no result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
