"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of ``repro``, the port's engine layer runs
where ``jax`` cannot be imported (as on the card's machine), and
``chip_smoke.py`` refuses to run without a CUDA device or outside a
checkout."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def _run(args, cwd, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_importing_every_module_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch.')]), bad)\n")
    out = _run(["-c", code], ROOT, PYTHONPATH=str(ROOT / "src"))
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20 and bad.strip() == "[]", out.stdout


def test_the_engine_runs_where_jax_cannot_be_imported():
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['jaxlib'] = None\n"
        "import repro_torch.core, repro_torch.obs, repro_torch.cluster\n"
        "from repro_torch.core.simulator import SimConfig, simulate_async\n"
        "eng, s = simulate_async(SimConfig(), scale=0.001, exactly_once=True)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] == 'repro'\n"
        "             or sys.modules[n] is not None and n.split('.')[0] in ('jax', 'jaxlib'))\n"
        "print(int(s['records']), eng.metrics.duplicates_delivered, bad)\n")
    out = _run(["-c", code], ROOT, PYTHONPATH=str(ROOT / "src"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["33135", "0", "[]"], out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(map(_forbidden, names)), f"{path}:{node.lineno} {names}"


def test_chip_smoke_fails_without_cuda_and_outside_a_checkout(tmp_path):
    out = _run([str(ROOT / "chip_smoke.py")], ROOT, CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = _run([str(alone)], tmp_path, PYTHONPATH="")
    assert out.returncode != 0 and '"ok"' not in out.stdout
