"""The port's engine layer is the JAX package's, copied: every ``.py``
file under ``repro/core`` (``formats/`` and ``stores/`` included),
``repro/obs`` and ``repro/cluster`` has its twin at the same relative path
under ``repro_torch``, equal byte for byte once the package name is
rewritten, and no other file is there. ``core/store.py``, the
``repro.core.store`` import shim, is left out: the port never had that
import path.

The rewrite rule, the one edit a copy gets: every ``repro.`` that does
not follow a word character or a dot becomes ``repro_torch.``, and
``from repro import`` becomes ``from repro_torch import``. It holds for
docstrings and comments too.

    PYTHONPATH=src python -m pytest -q tests/test_torch_engine_copy.py

The three names the port takes from elsewhere in the JAX package
(``utils.stable_hash64``, ``data.generator.shufflebench_records`` and
``LoadGenerator``) are held to the same rule through their source. So
are the training input's ``train_input/tokens.py`` and ``__init__.py``,
and ``train_input/pipeline.py`` but for ``_make_device_put`` and the
two lines that carry its ``device`` keyword. And so are the checkpoint
and runtime layers' store-level modules: ``checkpoint/tiered.py``,
``checkpoint/__init__.py`` and ``runtime/stragglers.py``; and
``runtime/elastic.py`` but for its device count, ``new_mesh.size``.
"""

import ast
import difflib
import inspect
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
ENGINE = ("core", "obs", "cluster")
NOT_COPIED = {"core/store.py"}


def rewrite(text: str) -> str:
    text = re.sub(r"(?<![\w.])repro\.", "repro_torch.", text)
    return text.replace("from repro import", "from repro_torch import")


def _py_files(root: Path) -> set:
    return {p.relative_to(root).as_posix() for pkg in ENGINE
            for p in (root / pkg).rglob("*.py")}


ORIGINALS = sorted(_py_files(JAX_PKG) - NOT_COPIED)


def _same(want: str, got: str, name: str) -> None:
    if got != want:
        diff = "".join(difflib.unified_diff(
            want.splitlines(True), got.splitlines(True),
            f"rewrite(repro/{name})", f"repro_torch/{name}"))
        pytest.fail(f"repro_torch/{name} differs from its original:\n{diff}")


def test_the_rewrite_rule():
    assert rewrite("from repro.core.blob import X  # see ``repro.obs``") == \
        "from repro_torch.core.blob import X  # see ``repro_torch.obs``"
    assert rewrite("from repro import utils") == "from repro_torch import utils"
    # a word character or a dot before it: another name, left alone
    assert rewrite("my_repro.x a.repro.y repro_torch.z") == "my_repro.x a.repro.y repro_torch.z"


def test_the_copied_files_are_the_engine_layer():
    """The port holds exactly the engine's files but the shim: a file the
    JAX package gains later fails here until it is copied."""
    assert len(ORIGINALS) == 39
    assert _py_files(PORT) == set(ORIGINALS)
    assert not (PORT / "core" / "store.py").exists()


@pytest.mark.parametrize("name", ORIGINALS)
def test_copy_equals_its_original_after_the_rewrite(name):
    want = rewrite((JAX_PKG / name).read_text())
    _same(want, (PORT / name).read_text(), name)


def test_the_names_taken_from_outside_the_engine_are_the_originals():
    from repro import utils as jutils
    from repro.data import generator as jgen
    from repro_torch import utils
    from repro_torch.data import generator
    for jfn, fn in ((jutils.stable_hash64, utils.stable_hash64),
                    (jgen.shufflebench_records, generator.shufflebench_records),
                    (jgen.LoadGenerator, generator.LoadGenerator)):
        _same(rewrite(inspect.getsource(jfn)), inspect.getsource(fn), fn.__qualname__)
    from repro_torch.data import LoadGenerator, shufflebench_records
    assert (LoadGenerator, shufflebench_records) == (generator.LoadGenerator,
                                                     generator.shufflebench_records)
    from repro_torch.core import cache
    assert cache.stable_hash64 is utils.stable_hash64


# ---------------------------------------------------------------------------
# the training input: ``train_input/tokens.py`` and ``__init__.py`` are
# copies under the rule; so is ``pipeline.py`` but for ``_make_device_put``
# (JAX's ``device_put`` to a ``NamedSharding`` becomes a put on the
# pipeline's device) and the ``device`` keyword that reaches it
# ---------------------------------------------------------------------------

TRAIN_INPUT_COPIES = ["train_input/tokens.py", "train_input/__init__.py"]
PIPELINE = "train_input/pipeline.py"
# the two lines of ``pipeline.py`` outside ``_make_device_put`` that carry
# the port's ``device`` keyword
DEVICE_EDITS = (
    ("                 mesh=None, model_cfg=None, rules=None):\n",
     "                 mesh=None, model_cfg=None, rules=None, device=\"cuda\"):\n"),
    ("        self._put = (self._make_device_put(mesh, model_cfg, rules)\n",
     "        self._put = (self._make_device_put(mesh, model_cfg, rules, device)\n"),
)


def _method_lines(text: str, name: str) -> tuple:
    """The first and one past the last line index of the method ``name``."""
    (node,) = [n for n in ast.walk(ast.parse(text))
               if isinstance(n, ast.FunctionDef) and n.name == name]
    return node.lineno - 1, node.end_lineno


def _without_method(text: str, name: str) -> str:
    """``text`` with the method ``name`` (its ``def`` to its last line) cut."""
    lines = text.splitlines(True)
    a, b = _method_lines(text, name)
    return "".join(lines[:a] + lines[b:])


@pytest.mark.parametrize("name", TRAIN_INPUT_COPIES)
def test_train_input_copy_equals_its_original_after_the_rewrite(name):
    _same(rewrite((JAX_PKG / name).read_text()), (PORT / name).read_text(), name)


def test_the_pipeline_is_a_copy_but_for_its_device_put():
    want = rewrite((JAX_PKG / PIPELINE).read_text())
    for old, new in DEVICE_EDITS:
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    got = (PORT / PIPELINE).read_text()
    _same(_without_method(want, "_make_device_put"),
          _without_method(got, "_make_device_put"), PIPELINE)
    # the port's put is its own, and names no jax
    a, b = _method_lines(got, "_make_device_put")
    assert "jax" not in "".join(got.splitlines(True)[a:b])


def test_the_train_input_package_holds_the_copies_and_its_own_modules():
    """The JAX package's ``train_input`` files all have a twin; ``loop.py``
    and ``specs_check.py`` are the port's own (no checkpoints; no
    lowering), held against JAX's by ``tests/test_torch_shuffle_fed_loop.py``
    and ``tests/test_torch_input_specs.py``."""
    names = {p.name for p in (JAX_PKG / "train_input").glob("*.py")}
    assert names == {p.name for p in (PORT / "train_input").glob("*.py")}
    assert names == {"__init__.py", "tokens.py", "pipeline.py", "loop.py", "specs_check.py"}


# ---------------------------------------------------------------------------
# the checkpoint and runtime layers: ``checkpoint/tiered.py`` and
# ``__init__.py`` and ``runtime/stragglers.py`` are copies under the rule,
# ``runtime/elastic.py`` one with a recorded edit;
# ``blobstore_ckpt.py`` (which imports jax and ml_dtypes) and
# ``fault_tolerance.py`` are the port's own, held against JAX's by
# ``tests/test_torch_checkpoint.py`` and ``tests/test_torch_fault_tolerance.py``
# ---------------------------------------------------------------------------

RUNTIME_COPIES = ["checkpoint/tiered.py", "checkpoint/__init__.py", "runtime/stragglers.py"]


@pytest.mark.parametrize("name", RUNTIME_COPIES)
def test_checkpoint_and_runtime_copy_equals_its_original_after_the_rewrite(name):
    _same(rewrite((JAX_PKG / name).read_text()), (PORT / name).read_text(), name)


def test_the_elastic_plan_is_a_copy_but_for_the_device_count():
    """``runtime/elastic.py`` is the JAX package's under the rule with one
    edit: the port's meshes hold no device array, so the plan's device
    count is ``new_mesh.size`` for JAX's ``new_mesh.devices.size``."""
    want = rewrite((JAX_PKG / "runtime" / "elastic.py").read_text())
    assert want.count("new_mesh.devices.size") == 1
    _same(want.replace("new_mesh.devices.size", "new_mesh.size"),
          (PORT / "runtime" / "elastic.py").read_text(), "runtime/elastic.py")


def test_the_checkpoint_and_runtime_packages_hold_the_copies_and_their_own_modules():
    """Every file of the JAX package's ``checkpoint`` and ``runtime`` has a
    twin, and the port has no other."""
    def names(root, pkg):
        return {p.name for p in (root / pkg).glob("*.py")}
    assert names(JAX_PKG, "checkpoint") == names(PORT, "checkpoint") == \
        {"__init__.py", "blobstore_ckpt.py", "tiered.py"}
    assert names(JAX_PKG, "runtime") == names(PORT, "runtime") == \
        {"__init__.py", "elastic.py", "fault_tolerance.py", "stragglers.py"}
