"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch <id> ...``

Batched autoregressive decode with the KV/state cache, as
``repro.launch.serve`` does it: the prompt is fed token by token through
the decode step, then ``--tokens`` tokens are generated greedily.
Parameters are drawn from ``--seed`` on ``--device`` (default ``cuda``);
``--smoke`` (default) takes the reduced config, ``--full`` the published
one. An encoder (hubert-xlarge) has no decode step: the launcher
refuses it by name, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import time

import torch


def generate(cfg, params, prompts: torch.Tensor, new_tokens: int, *,
             scfg=None, mesh=None) -> dict:
    """Feed ``prompts`` (B, P) token by token through the decode step of
    ``scfg`` (default ``ServeConfig()``) on ``mesh``, then generate
    ``new_tokens`` greedily. Returns the logits of every
    step (B, P + new_tokens - 1, V), the generated tokens (B, new_tokens)
    and the seconds the loop took (the device synchronised). Decode takes
    tokens only, with a vision frontend too; an encoder raises
    ``ValueError``."""
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, make_decode_step

    B, P = prompts.shape
    max_seq = P + new_tokens
    cache = lm.init_cache(cfg, B, max_seq, prompts.device)
    serve_step = make_decode_step(cfg, scfg or ServeConfig(), mesh)
    nxt = prompts[:, 0]
    logits, generated = [], []
    t0 = time.perf_counter()
    for t in range(max_seq - 1):
        tok = prompts[:, t:t + 1] if t < P else nxt[:, None]
        cache, nxt, step_logits = serve_step(params, cache, {"tokens": tok, "pos": t})
        logits.append(step_logits[:, 0])
        if t >= P - 1:
            generated.append(nxt)
    if prompts.is_cuda:
        torch.cuda.synchronize(prompts.device)
    return {"logits": torch.stack(logits, dim=1),
            "generated": torch.stack(generated, dim=1),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.common import init_params

    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only (no decode step)")
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(lm.LM(cfg, device=device), gen)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    out = generate(cfg, params, prompts, args.tokens)
    steps = out["logits"].shape[1]
    print(f"arch={cfg.name} device={device} batch={args.batch} {steps} steps in "
          f"{out['seconds']:.2f}s ({steps * args.batch / out['seconds']:.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
