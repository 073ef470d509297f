"""The port's training path against the JAX package's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_training.py

(a) The loss function's gradients against ``jax.grad`` of JAX's
    ``make_loss_fn`` at SMOKE with f32 compute, for zamba2 (the flash
    branch and the SSD chunk), deepseek-v2-lite (MLA, the dense MoE
    dispatch through the pack and unpack Functions), qwen2-moe,
    granite-3-2b (GQA, tied embeddings), hubert-xlarge (audio frames,
    the non-causal flash branch) and llava-next-34b (patches before the
    tokens, their labels ignored), each under remat none, dots and full,
    and the remat units themselves;
(b) ``cross_entropy``, ``schedule`` and ``adamw_update`` against JAX's,
    and the cases of ``tests/test_training.py``: microbatch accumulation,
    the ignore mask, clipping, a short run whose loss falls;
(c) one train step's updated parameters against JAX's;
(d) ``data.lm_batch_stream`` (text, and the audio and vision batches
    against the JAX package's shapes, dtypes and ignore mask) and the
    launcher on the CPU.

JAX parameters come over through ``interop.params_from_jax``, and JAX
gradient trees through the same function (they have the parameter
tree's shape); batches are made with numpy from a seed. Tolerances: the
gradients 2e-4 atol and rtol, the bound of ``tests/test_multidevice.py``'s
dispatch gradients (the same math in another order, summed over up to
thousands of terms); the optimizer and the loss in f32, 1e-6 relative
(one or two roundings apart); a train step's parameters 1e-5 where the
gradient is above 1e-5, and where it is not (AdamW's first step is
lr * g / (|g| + eps), which the gradients' rounding noise sets there)
1e-5 from the first step on the port's own gradient.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.data import lm_batch_stream as jlm_batch_stream
from repro.models import lm as jlm
from repro.models.common import init_params as jax_init_params
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import adamw_init as jadamw_init
from repro.training import make_loss_fn as jmake_loss_fn
from repro.training import make_train_step as jmake_train_step
from repro.training.optimizer import adamw_update as jadamw_update
from repro.training.optimizer import schedule as jschedule
from repro.training.train_step import _grads as jtrain_grads
from repro.training.train_step import cross_entropy as jcross_entropy
from repro_torch.configs import get_config
from repro_torch.data import lm_batch_stream
from repro_torch.interop import params_from_jax
from repro_torch.models import lm
from repro_torch.models.common import MultimodalConfig, init_params
from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                  adamw_update, make_loss_fn, make_train_step)
from repro_torch.training.optimizer import global_norm, schedule
from repro_torch.training.train_step import IGNORE, _grads, cross_entropy

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 2e-4
ARCHS = {  # flash_min_seq 16 < S: zamba2's shared block and hubert take the flash branch
    "zamba2-2.7b": {"flash_min_seq": 16},
    "deepseek-v2-lite-16b": {},
    "qwen2-moe-a2.7b": {},
    "granite-3-2b": {},
    "hubert-xlarge": {"flash_min_seq": 16},
    "llava-next-34b": {},
}
B, S = 2, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0):
    kw = ARCHS.get(arch, {})
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), compute_dtype=jnp.float32,
                               **kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32, **kw)
    jparams = jax_init_params(jlm.param_defs(jcfg), jax.random.key(seed))
    # norms start at zero (weight 1 + w); give them values so they count
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(lambda a: np.asarray(a) + (
        0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if np.all(np.asarray(a) == 0) else 0), jparams)
    return jcfg, cfg, jparams


def _batch(vocab, b=B, s=S, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = IGNORE
    return tokens, labels


def _torch_batch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}


def _arch_batch(cfg, seed=3):
    """The arch's loss batch as numpy: tokens and labels (with ignored
    positions), frames for the audio frontend, or patches before fewer
    tokens for the vision one, with the patch positions' labels ignored
    as ``lm_batch_stream`` makes them."""
    tokens, labels = _batch(cfg.vocab_size, seed=seed)
    kind = cfg.multimodal.kind if cfg.multimodal is not None else None
    if kind is None:
        return {"tokens": tokens, "labels": labels}
    x = np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if kind == "audio":
        return {"frames": x, "labels": labels}
    P = cfg.multimodal.num_patches
    labels[:, :P] = IGNORE
    return {"tokens": tokens[:, P:], "patches": x[:, :P], "labels": labels}


def _close_tree(cfg, got: dict, jtree, atol, rtol):
    """Each parameter's entry of ``got`` against the JAX tree's leaf."""
    want = params_from_jax(cfg, jtree, device="cpu")
    for name, w in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(), w.detach().numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# (a) gradients of the loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads():
    """JAX's loss and gradients per (arch, remat), computed once."""
    cache = {}

    def get(arch, remat):
        if (arch, remat) not in cache:
            jcfg, _, jparams = _setup(arch)
            loss_fn = jmake_loss_fn(jcfg, JTrainConfig(remat=remat))
            batch = {k: jnp.asarray(v) for k, v in _arch_batch(jcfg).items()}
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p: loss_fn(p, batch), has_aux=True))(jparams)
            cache[arch, remat] = float(loss), jax.tree.map(np.asarray, g)
        return cache[arch, remat]
    return get


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_gradients_match_jax(jax_grads, arch, remat):
    jcfg, cfg, jparams = _setup(arch)
    want_loss, want = jax_grads(arch, remat)
    params = params_from_jax(cfg, jparams, device="cpu")
    loss_fn = make_loss_fn(cfg, TrainConfig(remat=remat))
    batch = {k: torch.from_numpy(v) for k, v in _arch_batch(cfg).items()}
    grads, metrics = _grads(loss_fn, params, batch, 1)
    total = float(metrics["loss"] + metrics["aux_loss"])
    np.testing.assert_allclose(total, want_loss, rtol=1e-5)
    _close_tree(cfg, grads, want, GRAD_TOL, GRAD_TOL)


@pytest.mark.parametrize("arch,units", [("zamba2-2.7b", 2), ("deepseek-v2-lite-16b", 3),
                                        ("mamba2-130m", 2)])
def test_remat_checkpoints_the_jax_units(monkeypatch, arch, units):
    """One checkpoint a decoder block (the dense one too), a Mamba2 block,
    or a hybrid group (zamba2 SMOKE: 4 layers, a shared block every 2)."""
    _, cfg, jparams = _setup(arch)
    params = params_from_jax(cfg, jparams, device="cpu")
    batch = _torch_batch(*_batch(cfg.vocab_size))
    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: calls.append(kw) or real(
        fn, *a, **kw))
    outs = {}
    for remat in ("none", "dots", "full"):
        calls.clear()
        outs[remat] = _grads(make_loss_fn(cfg, TrainConfig(remat=remat)), params, batch, 1)[0]
        assert len(calls) == (0 if remat == "none" else units)
        assert all(("context_fn" in kw) == (remat == "dots") for kw in calls)
    # recomputation runs the same ops on the same inputs
    for remat in ("dots", "full"):
        for name, g in outs["none"].items():
            assert torch.equal(outs[remat][name], g), (remat, name)


def test_remat_is_checked():
    _, cfg, jparams = _setup("zamba2-2.7b")
    with pytest.raises(ValueError, match="remat"):
        lm.forward(cfg, params_from_jax(cfg, jparams, device="cpu"),
                   {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, remat="some")


# ---------------------------------------------------------------------------
# (b) loss, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 9, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 9)).astype(np.int32)
    labels[1, 3:6] = IGNORE
    want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_loss))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cross_entropy_ignore_mask_and_certainty():
    labels = torch.tensor([[1, 2, IGNORE, IGNORE]])
    assert float(cross_entropy(torch.zeros((1, 4, 8)), labels)) == pytest.approx(
        np.log(8), rel=1e-5)
    logits = torch.full((1, 2, 4), -30.0)
    logits[0, 0, 1] = logits[0, 1, 2] = 30.0
    assert float(cross_entropy(logits, torch.tensor([[1, 2]]))) < 1e-5


def test_schedule_matches_jax():
    cfg = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 140):
        want = float(jschedule(JOptConfig(**cfg), jnp.int32(step)))
        got = float(schedule(OptConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(schedule(OptConfig(**cfg), torch.tensor(0))) == 0.0


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_update_matches_jax(clip):
    """Two AdamW steps on mamba2-130m SMOKE's parameters with numpy
    gradients: the parameters, both moments, the count, the norm, the lr."""
    jcfg, cfg, jparams = _setup("mamba2-130m")
    rng = np.random.default_rng(1)
    jgrads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.1,
                           jparams) for _ in range(2)]
    ocfg = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10, grad_clip=clip)
    jp, jopt = jparams, jadamw_init(jparams)
    params = params_from_jax(cfg, jparams, device="cpu")
    opt = adamw_init(params)
    for jg in jgrads:
        jp, jopt, jm = jadamw_update(JOptConfig(**ocfg), jg, jopt, jp)
        grads = {n: p.detach().clone() for n, p in
                 params_from_jax(cfg, jg, device="cpu").named_parameters()}
        params, opt, m = adamw_update(OptConfig(**ocfg), grads, opt, params)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(opt["count"]) == int(jopt["count"]) == 2
    _close_tree(cfg, dict(params.named_parameters()), jax.tree.map(np.asarray, jp), 1e-6, 1e-6)
    for k in ("m", "v"):
        _close_tree(cfg, opt[k], jax.tree.map(np.asarray, jopt[k]), 1e-9, 1e-6)


def test_microbatch_grad_accumulation_matches_full_batch():
    _, cfg, jparams = _setup("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = params_from_jax(cfg, jparams, device="cpu")
    batch = _torch_batch(*_batch(cfg.vocab_size, b=4, s=16))
    loss_fn = make_loss_fn(cfg, TrainConfig())
    g1, m1 = _grads(loss_fn, params, batch, 1)
    g4, m4 = _grads(loss_fn, params, batch, 4)
    # the ignored labels sit in microbatch 0 alone, so compare the
    # microbatches' mean of means with the mean over each microbatch
    mean = sum(float(cross_entropy(*_logits_labels(cfg, params, batch, i)))
               for i in range(4)) / 4
    np.testing.assert_allclose(float(m4["loss"]), mean, rtol=1e-5)
    assert float(global_norm(g1)) == pytest.approx(float(global_norm(g4)), rel=5e-2)


def _logits_labels(cfg, params, batch, i):
    mb = {k: v[i:i + 1] for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = lm.forward(cfg, params, mb)
    return logits, mb["labels"]


def test_grad_clip_bounds_update():
    _, cfg, jparams = _setup("mamba2-130m")
    params = params_from_jax(cfg, jparams, device="cpu")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(learning_rate=1e-3, grad_clip=1e-6)))
    step(params, adamw_init(params), _torch_batch(*_batch(cfg.vocab_size)))
    delta = max(float((p.detach() - before[n]).abs().max())
                for n, p in params.named_parameters())
    assert 0 < delta < 2e-3


def test_loss_decreases_short_run():
    """Overfit one batch (deepseek-v2-lite SMOKE, bf16 compute)."""
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    params = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(
        learning_rate=3e-3, warmup_steps=2, total_steps=40), microbatches=2))
    opt = adamw_init(params)
    batch = _torch_batch(*_batch(cfg.vocab_size, b=4, s=16))
    losses = []
    for _ in range(20):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] * 0.8, losses


# ---------------------------------------------------------------------------
# (c) one train step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-2.7b"])
def test_train_step_matches_jax(arch):
    """Two microbatches, remat full: the updated parameters and metrics."""
    jcfg, cfg, jparams = _setup(arch)
    tokens, labels = _batch(cfg.vocab_size, b=4)
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8)
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(opt=JOptConfig(**ocfg),
                                                        microbatches=2)))
    jp, _, jm = jstep(jparams, jadamw_init(jparams),
                      {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = params_from_jax(cfg, jparams, device="cpu")
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(**ocfg), microbatches=2))
    params, opt, m = step(params, adamw_init(params), _torch_batch(tokens, labels))
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    # AdamW's first step moves each parameter by lr * g / (|g| + eps): where
    # JAX's |g| is as small as the gradients' rounding noise, that ratio is
    # noise too, so there the update is held to the step from the port's
    # own gradient, itself held to JAX's within GRAD_TOL; elsewhere to
    # JAX's parameters
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jg, _ = jtrain_grads(jmake_loss_fn(jcfg, JTrainConfig()), jparams, batch, 2)
    start = params_from_jax(cfg, jparams, device="cpu")
    g_port, _ = _grads(make_loss_fn(cfg, TrainConfig()), start, _torch_batch(tokens, labels), 2)
    ocfg = OptConfig(**ocfg)
    scale = min(ocfg.grad_clip / max(float(m["grad_norm"]), 1e-9), 1.0) if ocfg.grad_clip else 1.0
    lr = float(m["lr"])
    want_g = params_from_jax(cfg, jax.tree.map(np.asarray, jg), device="cpu")
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    for (name, p), w, jgl, p0 in zip(params.named_parameters(), want.parameters(),
                                     want_g.parameters(), start.parameters()):
        g = g_port[name]
        np.testing.assert_allclose(g.numpy(), jgl.detach().numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
        gs, p0 = g * scale, p0.detach()
        own = p0 - lr * (gs / (gs.abs() + ocfg.eps) + ocfg.weight_decay * p0)
        w = w.detach()
        got = torch.where(jgl.detach().abs() < 1e-5, p.detach() - own, p.detach() - w)
        bound = 1e-5 + 1e-5 * w.abs()
        assert bool((got.abs() <= bound).all()), (name, float((got.abs() - bound).max()))


# ---------------------------------------------------------------------------
# (d) the batch stream and the launcher
# ---------------------------------------------------------------------------

def test_lm_batch_stream_is_step_keyed_and_shifted():
    fn = lm_batch_stream(50, 3, 7, device="cpu", seed=4)
    a, b, again = fn(0), fn(1), fn(0)
    assert a["tokens"].shape == a["labels"].shape == (3, 7)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert torch.equal(a["tokens"], again["tokens"]) and not torch.equal(
        a["tokens"], b["tokens"])
    # the stub frontends are audio and vision
    with pytest.raises(ValueError, match="frontend"):
        lm_batch_stream(50, 3, 7, multimodal=MultimodalConfig(kind="video"))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b"])
def test_lm_batch_stream_frontend_batches_have_the_jax_layout(arch):
    """The audio and vision batches: the keys, shapes and dtypes of the
    JAX package's, the patch positions' labels IGNORE and the others in
    the vocabulary, step-keyed."""
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    b, s = 3, 24
    fn = lm_batch_stream(cfg.vocab_size, b, s, multimodal=cfg.multimodal,
                         d_model=cfg.d_model, device="cpu", seed=1)
    got, again = fn(0), fn(0)
    want = jlm_batch_stream(jcfg.vocab_size, b, s, multimodal=jcfg.multimodal,
                            d_model=jcfg.d_model)(0)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == np.dtype(w.dtype).name, k
        assert torch.equal(got[k], again[k]), k
    labels = got["labels"].numpy()
    P = cfg.multimodal.num_patches if cfg.multimodal.kind == "vision" else 0
    jlabels = np.asarray(want["labels"])
    assert (labels[:, :P] == IGNORE).all() and (jlabels[:, :P] == -100).all()
    assert ((labels[:, P:] >= 0) & (labels[:, P:] < cfg.vocab_size)).all()
    assert ((jlabels[:, P:] >= 0) & (jlabels[:, P:] < cfg.vocab_size)).all()
    emb = got["frames"] if P == 0 else got["patches"]
    assert emb.dtype == torch.bfloat16 and 0.5 < float(emb.float().std()) < 1.5
    # the batch trains: the loss of a step is finite
    model = init_params(lm.LM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    _, metrics = make_loss_fn(cfg, TrainConfig())(model, got)
    assert bool(torch.isfinite(metrics["loss"]))


def test_train_launcher_runs_on_the_cpu_and_its_loss_falls():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-v2-lite-16b", "--smoke", "--device", "cpu", "--steps", "12",
         "--batch", "4", "--seq", "32", "--lr", "1e-2", "--microbatches", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    first, last = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)", out.stdout).groups())
    assert last < first, out.stdout


def test_entry_points_default_to_the_card():
    import inspect
    from repro_torch.launch import train
    assert inspect.signature(lm_batch_stream).parameters["device"].default == "cuda"
    src = inspect.getsource(train.main)
    assert 'ap.add_argument("--device", default="cuda")' in src
