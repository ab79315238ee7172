"""Quickstart on the PyTorch port: train a small model with SNGM (the
paper's optimizer) on the multi-tensor engine, then generate from it
greedily on the dense cache.  Imports no JAX.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch import prng
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.core import sngm
from repro_torch.core.schedules import poly_power
from repro_torch.data import SyntheticLM
from repro_torch.models import count, make_runtime, materialize, model_defs
from repro_torch.serving import greedy_generate
from repro_torch.training import make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    rt = make_runtime(args.device)

    # any ported architecture works: --arch style selection via ARCHS
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              vocab_size=64)   # small vocab: learns fast
    defs = model_defs(cfg)
    params = materialize(defs, prng.PRNGKey(0), rt.device)
    print(f"model: {cfg.name}  ({count(defs):,} params) on {rt.device}")

    steps = args.steps
    data = SyntheticLM(cfg.vocab_size, seq_len=32, batch_size=8, branching=4,
                       device=rt.device)
    opt = sngm(poly_power(2.0, steps, 1.1), beta=0.9, weight_decay=1e-4,
               fused="multi_tensor")
    # one TrainState: the engine's flat buffers own params and momentum
    state = opt.init_state(params)
    del params
    train_step = make_train_step(cfg, rt, opt, n_micro=2)

    for t in range(steps):
        state, stats = train_step(state, data.batch_at(t))
        if t % 10 == 0 or t == steps - 1:
            print(f"step {t:3d}  loss={float(stats['loss']):.4f}  "
                  f"||g||={float(stats['grad_norm']):.3f}  "
                  f"lr={float(stats['lr']):.4f}")
    print(f"(bigram-chain entropy floor: {data.optimal_loss():.3f} nats)")

    prompt = data.batch_at(999)["tokens"][:2, :16]
    out = greedy_generate(cfg, rt, state.params_view, prompt, max_new=8)
    print("generated continuation token ids:", out.tolist())


if __name__ == "__main__":
    main()
