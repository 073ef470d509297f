"""The dry run's twin (``repro_torch.launch.dryrun``) and what it reads
(``ShardingRules.override``, ``NamedSharding.shard_shape``,
``make_production_mesh``, ``ModelConfig.active_param_count``,
``utils.tree_size_bytes``) against the JAX package's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py

One JAX subprocess (``JAX_REF``) imports ``repro.launch.dryrun`` first,
which sets 512 host devices before JAX's backend starts, and dumps:

* for all 31 cells on both production meshes (data 16 x model 16, pod 2 x
  data 16 x model 16): ``model_flops``, ``cell_rules(...).rules``,
  ``pick_q_chunk``, the microbatch count ``run_cell`` takes, and the bytes one device holds of each group of the step's inputs,
  rebuilt from JAX's own ``lm.param_defs``, ``serving_param_defs``,
  ``lm.cache_defs`` and ``input_specs`` as ``build_cell`` groups them, each
  leaf's ``NamedSharding(mesh, spec).shard_shape`` times its itemsize
  (nothing lowered);
* six SMOKE cells on ``make_test_mesh(devices=8)`` (granite-3-2b train and
  decode, deepseek-v2-lite-16b train and its MLA decode, zamba2-2.7b
  prefill, hubert-xlarge train; 8 x 64 tokens), each also lowered and
  compiled by ``build_cell``: XLA's ``memory_analysis()
  .argument_size_in_bytes``;
* ``active_param_count`` of each arch, ``--list``'s lines and the meshes'
  axes.

The port must equal every value exactly: bytes to the byte, the FLOPs to
the float. ``tree_size_bytes`` and ``override`` are held against JAX's in
this process, and the CLI in subprocesses of its own.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import utils as jutils
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import DEFAULT_RULES as JDEFAULT_RULES
from repro.models import lm as jlm
from repro.models.common import abstract_params
from repro_torch import configs, utils
from repro_torch.distributed import DEFAULT_RULES, NamedSharding, PartitionSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh
from repro_torch.models import lm
from repro_torch.models.common import ShapeConfig, init_params
from repro_torch.training import adamw_init

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
CELLS = [(kind, arch, shp) for kind in MESHES for arch, shp in configs.all_cells()]
SMOKE_CELLS = [("granite-3-2b", "train"), ("deepseek-v2-lite-16b", "train"),
               ("granite-3-2b", "decode"), ("deepseek-v2-lite-16b", "decode"),
               ("zamba2-2.7b", "prefill"), ("hubert-xlarge", "train")]
SMOKE_SEQ, SMOKE_BATCH = 64, 8
#: the keys of JAX's result that need a compiled program
COMPILED_KEYS = {"lower_s", "compile_s", "xla_cost_analysis", "hlo"}
COMPILED_MEMORY = {"output_bytes", "temp_bytes", "alias_bytes", "peak_est_bytes"}
COMPILED_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant", "step_time_s",
                     "useful_flops_ratio", "roofline_fraction"}

JAX_REF = """
import contextlib, io, json, math, sys
import repro.launch.dryrun as D          # first: sets 512 host devices
import jax
import jax.numpy as jnp
from repro.configs import ARCH_IDS, all_cells, get_config, get_shape
from repro.distributed.sharding import named_shardings
from repro.launch.mesh import make_production_mesh, make_test_mesh
from repro.launch.specs import input_specs
from repro.models import lm
from repro.models.common import ArraySpec, ShapeConfig, is_spec


def per_device(defs, rules, mesh):
    specs = jax.tree.leaves(defs, is_leaf=is_spec)
    shardings = jax.tree.leaves(named_shardings(defs, rules, mesh))
    return sum(math.prod(sh.shard_shape(s.shape)) * jnp.dtype(s.dtype).itemsize
               for s, sh in zip(specs, shardings))


def groups(cfg, shape, mesh):
    # build_cell's inputs, group by group
    rules = D.cell_rules(cfg, shape, mesh)
    if shape.step == "train":
        defs = lm.param_defs(cfg)
        f32 = jax.tree.map(D._float_to(jnp.float32), defs, is_leaf=is_spec)
        g = {"params": defs,
             "opt": {"m": f32, "v": f32, "count": ArraySpec((), jnp.int32, ())}}
    elif shape.step == "prefill":
        g = {"params": D.serving_param_defs(cfg)}
    else:
        g = {"params": D.serving_param_defs(cfg),
             "cache": lm.cache_defs(cfg, shape.global_batch, shape.seq_len)}
    g["batch"] = input_specs(cfg, shape)
    return {k: per_device(v, rules, mesh) for k, v in g.items()}


smoke_cells, seq, batch = json.loads(sys.argv[1])
out = {"cells": {}, "smoke": {}, "meshes": {},
       "active": {a: get_config(a).active_param_count() for a in ARCH_IDS}}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    out["meshes"][kind] = [list(mesh.axis_names), [mesh.shape[a] for a in mesh.axis_names]]
    for arch, shp in all_cells():
        cfg, shape = get_config(arch), get_shape(shp)
        out["cells"][f"{kind}/{arch}/{shp}"] = {
            "model_flops": D.model_flops(cfg, shape),
            "rules": {k: list(v) for k, v in D.cell_rules(cfg, shape, mesh).rules.items()},
            "q_chunk": D.pick_q_chunk(cfg, shape, mesh),
            "microbatches": D.MICROBATCH.get(arch, 1) if shape.step == "train" else 1,
            "groups": groups(cfg, shape, mesh)}
mesh = make_test_mesh(devices=8)
for arch, step in smoke_cells:
    cfg, shape = get_config(arch, smoke=True), ShapeConfig("smoke", seq, batch, step)
    mb = D.MICROBATCH.get(arch, 1) if step == "train" else 1
    fn, args = D.build_cell(cfg, shape, mesh, moe_mode="blob", grad_sync="auto",
                            microbatches=mb)
    compiled = fn.lower(*args).compile()
    out["smoke"][f"{arch}/{step}"] = {
        "xla": compiled.memory_analysis().argument_size_in_bytes,
        "groups": groups(cfg, shape, mesh)}
lines = io.StringIO()
sys.argv = ["dryrun", "--list"]
with contextlib.redirect_stdout(lines):
    D.main()
out["list"] = lines.getvalue().splitlines()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_ref():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_REF),
                        json.dumps([SMOKE_CELLS, SMOKE_SEQ, SMOKE_BATCH])],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return json.loads(r.stdout.splitlines()[-1])


def _run_cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                       cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout.splitlines()


# ---------------------------------------------------------------------------
# every cell on the production meshes
# ---------------------------------------------------------------------------

def test_every_cell_of_both_meshes_is_planned():
    assert len(CELLS) == 2 * 31


@pytest.mark.parametrize("kind,arch,shp", CELLS, ids=["/".join(c) for c in CELLS])
def test_cell_matches_jax(jax_ref, kind, arch, shp):
    want = jax_ref["cells"][f"{kind}/{arch}/{shp}"]
    cfg, shape = configs.get_config(arch), configs.get_shape(shp)
    mesh = make_production_mesh(multi_pod=kind == "multi")
    res = dryrun.run_cell(arch, shp, kind)
    mem, g = res["memory"], want["groups"]
    assert (mem["params_bytes"], mem["opt_bytes"], mem["cache_bytes"], mem["batch_bytes"]) == (
        g["params"], g.get("opt", 0), g.get("cache", 0), g["batch"])
    assert mem["argument_bytes"] == sum(g.values())
    assert dryrun.model_flops(cfg, shape) == want["model_flops"]
    assert res["roofline"]["model_flops_per_dev"] == want["model_flops"] / mesh.size
    assert res["devices"] == mesh.size == (512 if kind == "multi" else 256)
    rules = dryrun.cell_rules(cfg, shape, mesh).rules
    assert {k: list(v) for k, v in rules.items()} == want["rules"]
    assert dryrun.pick_q_chunk(cfg, shape, mesh) == want["q_chunk"]
    assert res["q_chunk"] == (None if shape.is_decode else want["q_chunk"])
    assert res["microbatches"] == want["microbatches"]


@pytest.mark.parametrize("arch,step", SMOKE_CELLS, ids=["/".join(c) for c in SMOKE_CELLS])
def test_smoke_cell_argument_bytes_equal_xlas_compiled(jax_ref, arch, step):
    """The port's plan on the 8-rank test mesh against the bytes XLA's
    compiled step takes as arguments, and JAX's groups."""
    want = jax_ref["smoke"][f"{arch}/{step}"]
    shape = ShapeConfig("smoke", SMOKE_SEQ, SMOKE_BATCH, step)
    got = dryrun.cell_state(configs.get_config(arch, smoke=True), shape,
                            make_test_mesh(devices=8))
    assert got == want["groups"]
    assert sum(got.values()) == want["xla"]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_active_param_count_matches_jax(jax_ref, arch):
    cfg = configs.get_config(arch)
    assert cfg.active_param_count() == jax_ref["active"][arch]
    if cfg.moe is None:
        assert cfg.active_param_count() == cfg.param_count()
    else:
        assert cfg.active_param_count() < cfg.param_count()


@pytest.mark.parametrize("kind", MESHES)
def test_production_mesh_matches_jax(jax_ref, kind):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    assert [list(mesh.axis_names), list(mesh.sizes)] == jax_ref["meshes"][kind]


# ---------------------------------------------------------------------------
# the pieces it reads
# ---------------------------------------------------------------------------

def test_override_matches_jax():
    kw = {"embed": (), "kv_embed": (), "kv_heads": (), "kv_seq": ("model",), "extra": ("pod",)}
    mine, want = DEFAULT_RULES.override(**kw), JDEFAULT_RULES.override(**kw)
    assert mine.rules == want.rules
    assert mine.rules is not DEFAULT_RULES.rules and DEFAULT_RULES.rules["embed"] == ("data",)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_tree_size_bytes_matches_jax(arch):
    for smoke in (True, False):
        cfg = configs.get_config(arch, smoke=smoke)
        jdefs = abstract_params(jlm.param_defs(jax_get_config(arch, smoke=smoke)))
        defs = lm.param_defs(cfg)
        assert jutils.tree_num_params(jdefs) == cfg.param_count()
        assert utils.tree_size_bytes(defs) == jutils.tree_size_bytes(jdefs)
        serving = dryrun.serving_param_defs(cfg)
        assert 2 * utils.tree_size_bytes(serving) == utils.tree_size_bytes(defs)


def test_cell_state_on_one_rank_is_the_bytes_of_the_train_state():
    """On a one-rank mesh the plan's groups are the bytes of the tensors a
    train step holds: the ``LM``'s parameters, ``adamw_init``'s state and
    the batch (``chip_smoke.py`` holds the same on the card)."""
    cfg = configs.get_config("deepseek-v2-lite-16b", smoke=True)
    shape = ShapeConfig("one_rank", SMOKE_SEQ, 2, "train")
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    batch = {k: torch.zeros((2, SMOKE_SEQ), dtype=torch.int32) for k in ("tokens", "labels")}
    got = dryrun.cell_state(cfg, shape, Mesh(("data", "model"), (1, 1)))
    assert got == {"params": utils.tree_size_bytes(dict(model.named_parameters())),
                   "opt": utils.tree_size_bytes(adamw_init(model)),
                   "batch": utils.tree_size_bytes(batch)}


def test_shard_shape_refuses_a_dimension_that_does_not_divide():
    sharding = NamedSharding(make_production_mesh(), PartitionSpec("model", None))
    assert sharding.shard_shape((32, 5)) == (2, 5)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_shape((24, 5))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_list_gives_jaxs_lines(jax_ref, tmp_path):
    assert _run_cli("--list", cwd=tmp_path) == jax_ref["list"]


def test_cli_one_cell_writes_the_documented_keys(tmp_path):
    lines = _run_cli("--arch", "deepseek-v2-lite-16b", "--shape", "decode_32k", "--mesh", "multi",
                     "--out", "plans", cwd=tmp_path)
    res = json.loads((tmp_path / "plans" / "multi" /
                      "deepseek-v2-lite-16b__decode_32k.json").read_text())
    assert res == json.loads(json.dumps(dryrun.run_cell(
        "deepseek-v2-lite-16b", "decode_32k", "multi")))
    assert set(res) == {"arch", "shape", "mesh", "step", "devices", "microbatches", "q_chunk",
                        "memory", "roofline"}
    assert set(res["memory"]) == {"argument_bytes", "params_bytes", "opt_bytes", "cache_bytes",
                                  "batch_bytes", "hbm_per_chip"}
    assert set(res["roofline"]) == {"model_flops_per_dev", "bound_s"}
    assert not (set(res) & COMPILED_KEYS or set(res["memory"]) & COMPILED_MEMORY
                or set(res["roofline"]) & COMPILED_ROOFLINE)
    assert res["devices"] == 512 and res["memory"]["cache_bytes"] > 0
    assert lines == [f"deepseek-v2-lite-16b decode_32k [multi] "
                     f"args={res['memory']['argument_bytes'] / 2**30:.2f}GiB "
                     f"bound={res['roofline']['bound_s']:.4f}s"]


def test_cli_default_out_is_apart_from_jaxs_results(tmp_path):
    """With no ``--out`` the plan goes under ``results/dryrun_torch``;
    nothing lands in JAX's ``results/dryrun``, whose readers expect the
    compiled program's keys."""
    _run_cli("--arch", "granite-3-2b", "--shape", "train_4k", cwd=tmp_path)
    assert [p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*.json")] == [
        "results/dryrun_torch/single/granite-3-2b__train_4k.json"]
    assert not (tmp_path / "results" / "dryrun").exists()


@pytest.mark.parametrize("flag", ["--moe-mode", "--grad-sync", "--microbatches", "--remat",
                                  "--cf", "--ssd-chunk", "--ssd-bf16", "--mla-absorb",
                                  "--compress-dcn"])
def test_cli_refuses_jaxs_step_flags(tmp_path, monkeypatch, capsys, flag):
    """JAX's step flags change only the compiled step, which the plan does
    not depend on: the twin refuses them rather than label an unchanged
    plan with them."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "granite-3-2b", "--shape",
                                      "train_4k", flag, "1"])
    with pytest.raises(SystemExit) as exit_:
        dryrun.main()
    assert exit_.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err
    assert not any(tmp_path.rglob("*.json"))


def test_cli_all_writes_every_cell_then_skips_them(tmp_path):
    _run_cli("--all", "--out", "plans", "--tag", "t", cwd=tmp_path)
    files = sorted((tmp_path / "plans" / "single").iterdir())
    assert [f.name for f in files] == sorted(f"{a}__{s}__t.json" for a, s in configs.all_cells())
    stamps = [f.stat().st_mtime_ns for f in files]
    lines = _run_cli("--all", "--out", "plans", "--tag", "t", cwd=tmp_path)
    assert lines == [f"skip (exists): {os.path.join('plans', 'single', f'{a}__{s}__t.json')}"
                     for a, s in configs.all_cells()] + ["all cells OK"]
    assert [f.stat().st_mtime_ns for f in files] == stamps
