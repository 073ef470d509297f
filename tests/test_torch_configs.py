"""The port's architecture registry (``repro_torch.configs``) against the
JAX package's (``repro.configs``): the ten ids in its order, every field
of every published and SMOKE config (dtypes by name, sub-configs such as
``MultimodalConfig`` field by field), the exact parameter count of each
published config (the port's module tree on the meta device against the
JAX package's parameter specs), the shape cells that apply to each
architecture and those that do not, with their reasons, and
``interop.params_from_jax`` carrying the parameter trees of the five
configs this registry gained (granite-3-2b, starcoder2-3b, qwen2-72b,
hubert-xlarge, llava-next-34b) at SMOKE size, bit for bit.

    PYTHONPATH=src python -m pytest -q tests/test_torch_configs.py

The port's ``ModelConfig`` leaves out two fields of the JAX package's,
``flash_q_chunk`` and ``flash_kv_chunk`` (the Pallas kernel's tiles,
which the CUDA kernel does not take); every other field must be there
with the JAX package's value.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.interop import params_from_jax, to_numpy
from repro_torch.models import common

NEW = ("granite-3-2b", "starcoder2-3b", "qwen2-72b", "hubert-xlarge", "llava-next-34b")

#: the JAX package's config fields that the port leaves out
LEFT_OUT = {"flash_q_chunk", "flash_kv_chunk"}


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _assert_same_fields(mine, want, where: str) -> None:
    """Every field of the port's dataclass ``mine`` equals the JAX
    package's ``want``: dtypes by name, dataclasses field by field."""
    names = {f.name for f in dataclasses.fields(mine)}
    want_names = {f.name for f in dataclasses.fields(want)}
    left_out = LEFT_OUT if isinstance(want, jcommon.ModelConfig) else set()
    assert names == want_names - left_out, (where, names ^ want_names)
    for name in sorted(names):
        a, b = getattr(mine, name), getattr(want, name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.is_dataclass(a), (where, name, a)
            _assert_same_fields(a, b, f"{where}.{name}")
        elif name.endswith("dtype"):
            assert _dtype_name(a) == _dtype_name(b), (where, name, a, b)
        else:
            assert a == b and type(a) is type(b), (where, name, a, b)


def test_the_ten_arch_ids_in_the_jax_order():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_config_field_equals_jax(arch, smoke):
    mine = configs.get_config(arch, smoke=smoke)
    want = jconfigs.get_config(arch, smoke=smoke)
    assert isinstance(mine, common.ModelConfig)
    _assert_same_fields(mine, want, arch)
    assert mine.has_decode == want.has_decode
    assert mine.sub_quadratic == want.sub_quadratic
    assert mine.resolved_head_dim == want.resolved_head_dim
    if want.multimodal is not None:
        assert isinstance(mine.multimodal, common.MultimodalConfig)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_equals_jax(arch):
    assert (configs.get_config(arch).param_count()
            == jconfigs.get_config(arch).param_count())


def test_param_counts_of_the_new_configs():
    """The counts that chip_smoke.py's phases check at full width."""
    want = {"granite-3-2b": 2_533_531_648, "starcoder2-3b": 3_181_086_720,
            "hubert-xlarge": 945_624_320, "llava-next-34b": 34_388_917_248,
            "qwen2-72b": 72_706_203_648}
    assert {a: configs.get_config(a).param_count() for a in want} == want


def _names(shapes):
    return [s.name for s in shapes]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_applicable_and_skipped_shapes_equal_jax(arch):
    mine, want = configs.get_config(arch), jconfigs.get_config(arch)
    assert _names(common.applicable_shapes(mine)) == _names(jcommon.applicable_shapes(want))
    assert common.skipped_shapes(mine) == jcommon.skipped_shapes(want)


def test_shapes_cells_and_skips_equal_jax():
    for s, js in zip(common.ALL_SHAPES, jcommon.ALL_SHAPES, strict=True):
        assert dataclasses.astuple(s) == dataclasses.astuple(js)
        assert configs.get_shape(s.name) == s and s.is_decode == js.is_decode
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("decode_1m")
    assert list(configs.all_cells()) == list(jconfigs.all_cells())
    assert list(configs.all_skips()) == list(jconfigs.all_skips())
    # the encoder has no decode cell
    assert ("hubert-xlarge", "decode_32k") not in set(configs.all_cells())


@pytest.mark.parametrize("arch", NEW)
def test_params_from_jax_carries_the_new_trees_bit_for_bit(arch):
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    jparams = jcommon.init_params(jlm.param_defs(jcfg), jax.random.key(0))
    rng = np.random.default_rng(0)
    # the zero-initialised norms and biases get values, so each leaf differs
    jparams = jax.tree.map(lambda a: np.asarray(a) + (
        rng.standard_normal(a.shape).astype(np.float32) if not np.asarray(a).any() else 0),
        jparams)
    model = params_from_jax(cfg, jparams, device="cpu")
    got = dict(model.named_parameters())
    seen = set()
    for path, leaf in jax.tree.leaves_with_path(jparams):
        keys = [k.key for k in path]
        leaf = np.asarray(leaf)
        if keys[0] in ("blocks", "dense_blocks"):
            rows = [(f"{keys[0]}.{i}.{'.'.join(keys[1:])}", leaf[i]) for i in range(len(leaf))]
        else:
            rows = [(".".join(keys), leaf)]
        for name, want in rows:
            mine = to_numpy(got[name])
            assert mine.dtype == want.dtype and mine.shape == want.shape, name
            assert np.array_equal(mine.view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8)), name
            seen.add(name)
    assert seen == set(got)
