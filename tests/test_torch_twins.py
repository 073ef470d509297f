"""The port's file list against the JAX package's: every ``.py`` file of
``src/repro`` has a twin at the same path under ``src/repro_torch`` but
for those named in ``NO_TWIN``, which ROADMAP.md lists as the files with
no twin."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the JAX package's deprecated ``repro.core.store`` import shim (not
#: copied), its JAX version shims (no twin needed), and the dry run's HLO
#: analysis, which parses the HLO text of XLA's compiled program: torch
#: produces no such text
NO_TWIN = {"core/store.py", "jaxcompat.py", "launch/hlo_analysis.py"}


def _files(package: str) -> set:
    base = ROOT / "src" / package
    return {p.relative_to(base).as_posix() for p in base.rglob("*.py")}


def test_every_file_of_the_jax_package_has_a_twin_but_the_named_four():
    assert _files("repro") - _files("repro_torch") == NO_TWIN
