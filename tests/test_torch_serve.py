"""The port's serving path: the prefill and decode steps of
``repro_torch.serving`` against the JAX package's, the gap between
prefill and decode logits of one prompt held to the gap the JAX package
shows itself, and the serve CLI on the CPU."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.common import init_params as jax_init_params
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax, to_numpy
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import (ServeConfig, greedy_sample, make_decode_step,
                                 make_prefill_step)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    jparams = jax.tree.map(np.asarray, jax_init_params(jlm.param_defs(jcfg),
                                                       jax.random.key(seed)))
    return jcfg, cfg, jparams, params_from_jax(cfg, jparams, device="cpu")


def _prompts(vocab, B, S, seed=11):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _jax_gap(jcfg, jparams, tok):
    """max |prefill - decode| over the prompt's logits, in the JAX package."""
    B, S = tok.shape
    prefill = jax.jit(jengine.make_prefill_step(jcfg, jengine.ServeConfig()))
    want = np.asarray(prefill(jparams, {"tokens": jnp.asarray(tok)}), np.float32)
    step = jax.jit(jengine.make_decode_step(jcfg, jengine.ServeConfig()))
    cache = jax_init_params(jlm.cache_defs(jcfg, B, S), jax.random.key(1))
    gap = 0.0
    for t in range(S):
        cache, _, logits = step(jparams, cache, {"tokens": jnp.asarray(tok[:, t:t + 1]),
                                                 "pos": jnp.int32(t)})
        gap = max(gap, float(np.abs(np.asarray(logits[:, 0], np.float32) - want[:, t]).max()))
    return gap, want


def _port_gap(cfg, model, tok):
    B, S = tok.shape
    got = make_prefill_step(cfg, ServeConfig())(model, {"tokens": torch.from_numpy(tok)})
    step = make_decode_step(cfg, ServeConfig())
    cache = lm.init_cache(cfg, B, S, device="cpu")
    gap = 0.0
    for t in range(S):
        cache, nxt, logits = step(model, cache, {"tokens": torch.from_numpy(tok[:, t:t + 1]),
                                                 "pos": t})
        assert torch.equal(nxt, greedy_sample(logits))
        gap = max(gap, float((logits[:, 0].float() - got[:, t].float()).abs().max()))
    return gap, got


ARCHS = ["zamba2-2.7b", "mamba2-130m", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "gemma-2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_gap_within_twice_jax(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    tok = _prompts(cfg.vocab_size, 4, 16)
    jgap, jlogits = _jax_gap(jcfg, jparams, tok)
    gap, logits = _port_gap(cfg, model, tok)
    # the two prefills agree within the bf16 model tolerance of
    # tests/test_torch_zamba2.py
    np.testing.assert_allclose(to_numpy(logits.float()), jlogits, atol=1e-1, rtol=0)
    assert gap <= 2 * jgap, (gap, jgap)


def test_prefill_matches_jax_in_f32():
    jcfg, cfg, jparams, model = _setup("zamba2-2.7b", compute_dtype=jnp.float32)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    tok = _prompts(cfg.vocab_size, 2, 24)
    prefill = jax.jit(jengine.make_prefill_step(jcfg, jengine.ServeConfig()))
    want = np.asarray(prefill(jparams, {"tokens": jnp.asarray(tok)}))
    got = make_prefill_step(cfg, ServeConfig())(model, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-4, rtol=0)
    assert torch.equal(greedy_sample(got),
                       torch.from_numpy(np.array(jengine.greedy_sample(jnp.asarray(want)))))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--tokens", "6"])
    cfg = get_config(arch, smoke=True)
    assert out["logits"].shape == (2, 10, cfg.vocab_size)
    assert bool(torch.isfinite(out["logits"].float()).all())
    gen = out["generated"]
    assert gen.shape == (2, 6) and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size


def test_serve_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                          "--device", "cpu", "--prompt-len", "3", "--tokens", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "arch=zamba2-smoke device=cpu batch=4 4 steps" in out.stdout


def test_decode_writes_the_cache_in_place():
    _, cfg, _, model = _setup("zamba2-2.7b")
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    k0 = cache["shared"]["k"]
    step = make_decode_step(cfg, ServeConfig())
    cache2, _, _ = step(model, cache, {"tokens": torch.tensor([[3]]), "pos": 0})
    assert cache2 is cache and cache2["shared"]["k"] is k0
    assert float(k0[:, :, 0].abs().sum()) > 0 and float(k0[:, :, 1:].abs().sum()) == 0
    assert float(cache["blocks"]["state"].abs().sum()) > 0


def test_shuffle_config_has_the_jax_fields():
    """ShuffleConfig has the JAX package's fields and defaults, and
    ServeConfig.shuffle its default, which both steps pass to the MoE
    layers. ServeConfig leaves out the JAX package's temperature, which
    nothing reads there either."""
    from repro.shuffle.api import ShuffleConfig as JaxShuffleConfig
    from repro_torch.shuffle.api import ShuffleConfig
    jf = {f.name: f.default for f in dataclasses.fields(JaxShuffleConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(ShuffleConfig)}
    assert mine == jf
    assert ServeConfig().shuffle == ShuffleConfig(mode="dense")
    assert [f.name for f in dataclasses.fields(ServeConfig)] == ["shuffle"]
