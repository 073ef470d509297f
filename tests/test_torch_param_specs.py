"""The port's parameter specs and their shardings (``models.lm.param_defs``,
``distributed.named_shardings``, ``runtime.elastic_restore_plan``) against
the JAX package's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_param_specs.py

* ``lm.param_defs`` equals JAX's ``param_defs`` leaf for leaf (key
  paths, shapes, dtype names, logical axes, ``init`` and ``init_scale``)
  for all ten configs, SMOKE and published; the port reads it off an
  ``LM`` built on the meta device. The MoE shared experts' hidden dim
  has no logical axis in either package (replicated).
* ``named_shardings`` gives JAX's ``PartitionSpec`` string for every leaf
  of every config, SMOKE and published, on the 8- and 4-rank test
  meshes, ``chip_smoke.py``'s ``EP_MESH`` (pod 2, data 1, model 16) and
  (pod 1, data 4, model 4). JAX's side runs over an ``AbstractMesh`` of
  the same axes: this process has one CPU device (the plans on JAX's
  real 8- and 4-device meshes are held in
  ``tests/test_torch_fault_tolerance.py``'s JAX subprocess).
* ``elastic_restore_plan`` takes ``dp_degree`` from the pod and data
  axes and ``devices`` from the mesh's size, on the same four meshes.
"""

import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.distributed.sharding import DEFAULT_RULES as JDEFAULT_RULES
from repro.distributed.sharding import named_shardings as jnamed_shardings
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.distributed import DEFAULT_RULES, NamedSharding, named_shardings
from repro_torch.launch.mesh import make_test_mesh, stacked_mesh
from repro_torch.models import lm
from repro_torch.runtime import elastic_restore_plan

MESHES = {"test8": make_test_mesh(devices=8), "test4": make_test_mesh(devices=4),
          "ep": stacked_mesh(pod=2, data=1, model=16),
          "pod1_data4_model4": stacked_mesh(pod=1, data=4, model=4)}
#: the MoE shared experts, whose hidden dim JAX replicates
SHARED = ("w_gate", "w_up", "w_down")


def _leaves(tree, prefix=()) -> dict:
    """A nested dict -> {key path: leaf}."""
    if isinstance(tree, dict):
        return {path: leaf for k, v in tree.items()
                for path, leaf in _leaves(v, prefix + (k,)).items()}
    return {prefix: tree}


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if "torch" in str(dt) else np.dtype(dt).name


def _spec_row(spec) -> tuple:
    return (tuple(spec.shape), _dtype_name(spec.dtype), tuple(spec.axes), spec.init,
            spec.init_scale)


def _configs(arch, smoke):
    return configs.get_config(arch, smoke=smoke), jconfigs.get_config(arch, smoke=smoke)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_defs_match_jax(arch, smoke):
    cfg, jcfg = _configs(arch, smoke)
    mine, want = _leaves(lm.param_defs(cfg)), _leaves(jlm.param_defs(jcfg))
    assert sorted(mine) == sorted(want)
    differ = {"/".join(path): (_spec_row(mine[path]), _spec_row(want[path]))
              for path in want if _spec_row(mine[path]) != _spec_row(want[path])}
    assert not differ
    if cfg.moe is not None and cfg.moe.num_shared:
        for name in SHARED:
            spec = mine[("blocks", "ffn", "shared", name)]
            assert None in spec.axes and "mlp" not in spec.axes


def test_param_defs_of_the_published_config_hold_no_memory():
    """The published widths are specs only: deepseek-v2-lite's 15.7 G
    parameters, counted off the specs, with every layer stacked."""
    cfg = configs.get_config("deepseek-v2-lite-16b")
    specs = _leaves(lm.param_defs(cfg))
    assert sum(int(np.prod(s.shape)) for s in specs.values()) == cfg.param_count()
    assert {s.shape[0] for p, s in specs.items() if p[0] == "blocks"} == {26}
    assert {s.shape[0] for p, s in specs.items() if p[0] == "dense_blocks"} == {1}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_named_shardings_match_jax(arch, smoke, mesh):
    cfg, jcfg = _configs(arch, smoke)
    m = MESHES[mesh]
    mine = _leaves(named_shardings(lm.param_defs(cfg), DEFAULT_RULES, m))
    jmesh = AbstractMesh(tuple(m.sizes), tuple(m.axis_names))
    want = _leaves(jnamed_shardings(jlm.param_defs(jcfg), JDEFAULT_RULES, jmesh))
    assert sorted(mine) == sorted(want)
    assert all(isinstance(s, NamedSharding) and s.mesh is m for s in mine.values())
    differ = {"/".join(p): (str(mine[p].spec), str(want[p].spec))
              for p in want if str(mine[p].spec) != str(want[p].spec)}
    assert not differ


@pytest.mark.parametrize("mesh, dp, devices", [("test8", 4, 8), ("test4", 2, 4),
                                               ("ep", 2, 32), ("pod1_data4_model4", 4, 16)])
def test_elastic_restore_plan(mesh, dp, devices):
    cfg = configs.get_config("deepseek-v2-lite-16b")
    defs = lm.param_defs(cfg)
    plan = elastic_restore_plan(defs, DEFAULT_RULES, MESHES[mesh])
    assert (plan["dp_degree"], plan["devices"]) == (dp, devices)
    assert plan["shardings"] == named_shardings(defs, DEFAULT_RULES, MESHES[mesh])
