"""The port stands alone: veneur_tpu_torch and chip_smoke.py import
neither jax nor anything of veneur_tpu.

An AST scan covers every import statement; a subprocess with ``jax`` and
``veneur_tpu`` blocked from import then imports every module of the port
and chip_smoke, so an import hidden behind a string or a call would fail
there too.
"""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "veneur_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "veneur_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods + ["chip_smoke"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_jax_or_reference_imports():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path.name, node.module))
    assert not bad, bad
    assert len(_sources()) > 20


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in list(sys.modules):\n"
        "    if name.split('.')[0] in {blocked!r}:\n"
        "        del sys.modules[name]\n"
        "for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        "for mod in {mods!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('imported', len({mods!r}))\n"
    ).format(blocked=FORBIDDEN, mods=_modules())
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
