"""Batched serving on the PyTorch port's dense engine: prefill a batch
of prompts, grow the cache with ``pad_cache``, then decode step by step.
Imports no JAX.

With ``--long-context`` the arch's ``for_long_context()`` variant is
served (every layer sliding-window, W = 64 in the smoke variant): a
prompt longer than W leaves each layer a rotated ring of its last W
positions, which is the whole decode state, so it is decoded as it is,
without padding (``pad_cache`` refuses a rotated ring).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu] \\
        [--arch yi-9b --long-context --prompt-len 80]

MLA, SSM and encoder-decoder archs are not ported yet and raise
``NotImplementedError``.
"""
import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.models import make_runtime, materialize, model_defs
from repro_torch.serving import make_prefill_step, make_serve_step, pad_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--long-context", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    rt = make_runtime(args.device)

    cfg = smoke_variant(ARCHS[args.arch])
    if args.long_context:
        cfg = cfg.for_long_context()
    params = materialize(model_defs(cfg), prng.PRNGKey(0), rt.device)
    prompts = prng.randint(prng.PRNGKey(1), (args.batch, args.prompt_len), 0,
                           cfg.vocab_size).to(rt.device)

    prefill = make_prefill_step(cfg, rt)
    serve = make_serve_step(cfg, rt)

    t0 = time.time()
    logits, cache = prefill(params, prompts)
    rotated = bool(cfg.window) and args.prompt_len > cfg.window
    if not rotated:
        cache = pad_cache(cache, args.max_new)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    seq = cache["blocks.L0.attn.k"].shape[2]
    print(f"prefill {args.batch}x{args.prompt_len}: {time.time() - t0:.2f}s "
          f"(cache leaves: {len(cache)}, layer-0 length {seq}"
          f"{', a rotated ring' if rotated else ''})")

    out = [tok]
    pos = torch.full((args.batch,), args.prompt_len, dtype=torch.int32,
                     device=rt.device)
    t0 = time.time()
    for _ in range(args.max_new - 1):
        tok, _, cache = serve(params, cache, tok[:, None], pos)
        out.append(tok)
        pos = pos + 1
    toks = torch.stack(out, dim=1).tolist()
    dt = time.time() - t0
    print(f"decoded {args.max_new} tokens/seq in {dt:.2f}s "
          f"({args.batch * args.max_new / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", toks[0])


if __name__ == "__main__":
    main()
