#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Serves the full published widths of gemma-2b (random weights from a
seed) through the port's paged scheduler on one NVIDIA GPU, with decode
attention in the hand-written CUDA kernel, and holds that kernel against
its plain PyTorch version.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit), versions, the kernel's
     build time and its ptxas register/spill lines;
  2. the kernel against its plain version on the card, fp32 and bf16,
     over head-group, kv-head, head-dim and block-size grids, window and
     softcap, frontiers on and inside blocks, an inactive row, and the
     gemma-2b decode shape;
  3. full-width serving: 16 requests arriving two per scheduler round on
     8 slots, four prompts sharing a 256-token prefix, a pool small
     enough to preempt; the kernel's launch count must be
     n_layers x decode steps;
  4. the whole decode path through the kernel against the model's plain
     gather path on the card, teacher-forced on the same tokens, at the
     served bf16 compute and at fp32 compute;
  5. one JSON line of kernel timings against their bounds, then the
     JSON result line.

It exits non-zero, printing no result, without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12                 # CUDA cores: the kernel's fp32 FMAs
TOL = {"float32": 2e-5, "bfloat16": 3e-2}     # kernel vs plain, max abs
# phase 4: |logits(kernel path) - logits(gather path)| <= LOGIT_REL x max|logits|.
# fp32 compute holds the whole path tightly: the two attention paths sum
# in other orders (~1e-7), and the random stack amplifies that to ~1e-4
# (measured on narrow 18-layer stand-ins on the CPU).  At the served
# bf16 compute the gather path rounds the softmax probabilities to bf16
# before the PV product while the kernel keeps them in fp32; the random
# weights (drawn at fan-in n_layers, as in the JAX package) turn that
# bf16-level difference into logit differences of 0.2-0.3 of the largest
# logit on the same stand-ins, so the bf16 bound only rules out garbage
# (unrelated logits differ by 1-2).
LOGIT_REL = {"float32": 1e-2, "bfloat16": 1.0}

ARCH = "gemma-2b"
SLOTS, BLOCK_SIZE, DECODE_CHUNK, MAX_NEW = 8, 16, 4, 64
N_REQUESTS, PER_ROUND, PROMPT_LO, PROMPT_HI = 16, 2, 96, 480
SHARED_PREFIX, SHARERS = 256, (0, 3, 5, 6)
POOL_BLOCKS = 120                  # 119 usable: below the peak demand, so it preempts


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def traffic(vocab: int, seed: int = 0):
    """Prompt token arrays: lengths drawn from the seed in
    [PROMPT_LO, PROMPT_HI]; the SHARERS begin with one shared prefix."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    prefix = rng.randint(0, vocab, SHARED_PREFIX)
    prompts = []
    for i, n in enumerate(lengths):
        p = rng.randint(0, vocab, int(n))
        if i in SHARERS:
            p = np.concatenate([prefix, p[:max(16, int(n) - SHARED_PREFIX)]])
        prompts.append(p.astype(np.int32))
    return prompts


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------

def phase_card(torch, ops):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    lib = ops.library()
    log(f"{'built' if lib.built else 'loaded'} {lib.path.relative_to(ROOT)} "
        f"in {lib.seconds:.2f} s")
    for line in lib.ptxas:
        log(f"ptxas: {line}")


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def make_case(torch, B, H, K, hd, bs, nbmax, n_blocks, pos, dtype, seed,
              inactive_last=False):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, hd, device="cuda", generator=g).to(dt)
    kp = torch.randn(n_blocks, bs, K, hd, device="cuda", generator=g).to(dt)
    vp = torch.randn(n_blocks, bs, K, hd, device="cuda", generator=g).to(dt)
    ids = torch.randperm(n_blocks - 1, device="cuda", generator=g)[:B * nbmax] + 1
    bt = ids.reshape(B, nbmax).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    if inactive_last:                  # a free slot: table at scratch, pos 0
        bt[-1] = 0
        pos[-1] = 0
    return q, kp, vp, bt, pos


def max_err(torch, ops, ref, case, **kw):
    o = ops.paged_attention(*case, **kw)
    r = ref(*case, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError("kernel output is not finite")
    return (o.float() - r.float()).abs().max().item()


def phase_kernel(torch, ops, ref):
    worst = {}
    n = 0
    for dtype in ("float32", "bfloat16"):
        worst[dtype] = 0.0
        for G in (1, 4, 8):
            for K in (1, 2):
                for hd in (64, 128, 256):
                    for bs in (4, 16):
                        nbmax = 5
                        # frontiers: first slot, end of block 0, start of
                        # block 1, inside a partial block, the last slot
                        pos = [0, bs - 1, bs, 2 * bs + bs // 2 + 1,
                               nbmax * bs - 1, 0]
                        case = make_case(torch, 6, G * K, K, hd, bs, nbmax,
                                         1 + 6 * nbmax + 2, pos, dtype,
                                         seed=n, inactive_last=True)
                        kws = [{}]
                        if hd == 128:
                            kws += [dict(window=9), dict(softcap=30.0),
                                    dict(window=2 * bs + 3, softcap=20.0)]
                        for kw in kws:
                            e = max_err(torch, ops, ref, case, **kw)
                            if e > TOL[dtype]:
                                raise AssertionError(
                                    f"{dtype} G={G} K={K} hd={hd} bs={bs} "
                                    f"{kw}: max abs err {e:.3g} > {TOL[dtype]}")
                            worst[dtype] = max(worst[dtype], e)
                            n += 1
        log(f"kernel vs plain {dtype}: max abs err {worst[dtype]:.3g} "
            f"(tolerance {TOL[dtype]})")
    decode = decode_case(torch, seed=1)
    e = max_err(torch, ops, ref, decode)
    if e > TOL["bfloat16"]:
        raise AssertionError(f"gemma-2b decode shape: max abs err {e:.3g}")
    log(f"kernel vs plain at the gemma-2b decode shape (bf16, B=8 H=8 K=1 "
        f"hd=256 bs=16): max abs err {e:.3g}; {n + 1} cases agree")
    return e


def decode_case(torch, seed):
    """Phase 3's decode shape: 8 slots of gemma-2b (H 8, K 1, hd 256),
    block size 16, a table for the longest context, bf16 pools, and
    frontiers 32 tokens into the generation of the first 8 prompts.
    Every slot owns distinct blocks."""
    lengths = [len(p) for p in traffic(256000)[:SLOTS]]
    nbmax = -(-(PROMPT_HI + MAX_NEW) // BLOCK_SIZE)
    return make_case(torch, SLOTS, 8, 1, 256, BLOCK_SIZE, nbmax,
                     1 + SLOTS * nbmax, [n + 32 for n in lengths], "bfloat16",
                     seed)


# ---------------------------------------------------------------------------
# phase 3: full-width serving
# ---------------------------------------------------------------------------

def phase_serve(torch, kernels, serve_mod, cfg, rt):
    t0 = time.perf_counter()
    params, n_params = serve_mod.load_model(cfg, rt, seed=0)
    torch.cuda.synchronize()
    log(f"{cfg.name}: {n_params:,} params (fp32 draws, matmul weights cast "
        f"once to {cfg.compute_dtype}) in {time.perf_counter() - t0:.1f} s")
    prompts = traffic(cfg.vocab_size)
    sched = serve_mod.build_scheduler(
        cfg, params, rt, slots=SLOTS, block_size=BLOCK_SIZE,
        blocks=POOL_BLOCKS, ctx=PROMPT_HI + MAX_NEW, decode_chunk=DECODE_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    finished = serve_mod.serve(sched, prompts, MAX_NEW, per_round=PER_ROUND)
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()["paged_decode_attention"]
    st = sched.stats
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    lats = [r.t_done - r.t_submit for r in finished]
    tokens = sum(len(r.out) for r in finished)
    log(f"served {len(finished)} requests, {tokens} tokens in {dt:.2f} s: "
        f"{tokens / dt:.1f} tok/s; latency p50 {np.percentile(lats, 50):.3f} s "
        f"p99 {np.percentile(lats, 99):.3f} s")
    log(f"peak blocks {st['peak_used_blocks']}/{POOL_BLOCKS - 1}, preemptions "
        f"{st['preemptions']}, COW-shared blocks {st['cow_shared_blocks']}, "
        f"prefill calls {st['prefill_calls']}, decode steps {st['decode_steps']}, "
        f"peak device memory {peak_gib:.2f} GiB")
    log(f"paged_decode_attention launches {launches} = {cfg.n_layers} layers x "
        f"{st['decode_steps']} decode steps")
    log(f"host time: prefill {st['prefill_s']:.3f} s over {st['prefill_calls']} "
        f"calls, decode {st['decode_s']:.3f} s = "
        f"{st['decode_s'] / st['decode_steps'] * 1e3:.2f} ms per decode step")
    if sorted(r.rid for r in finished) != list(range(N_REQUESTS)):
        raise AssertionError("not every request finished")
    if any(len(r.out) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in r.out)
           for r in finished):
        raise AssertionError("a request emitted the wrong number of tokens or "
                             "a token outside the vocabulary")
    if launches != cfg.n_layers * st["decode_steps"] or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{st['decode_steps']} decode steps")
    if st["preemptions"] < 1 or st["cow_shared_blocks"] < 1:
        raise AssertionError("the traffic did not preempt or share a prefix")
    sched.alloc.check()
    if sched.alloc.used_blocks:
        raise AssertionError(f"{sched.alloc.used_blocks} blocks leaked")
    return params, launches, st["decode_s"] / st["decode_steps"] * 1e3


# ---------------------------------------------------------------------------
# phase 4: whole decode path, kernel against plain gather
# ---------------------------------------------------------------------------

def phase_path(torch, cfg, params, Runtime, device, serving, steps=4):
    """Prefill 8 prompts once, splice them into two pools, and run
    ``steps`` teacher-forced decode steps through the kernel path and
    through the model's plain gather path."""
    from repro_torch.serving import paged_cache as pc
    prompts = traffic(cfg.vocab_size, seed=1)[:SLOTS]
    S = max(len(p) for p in prompts)
    toks = np.zeros((SLOTS, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    last = np.array([len(p) - 1 for p in prompts], np.int32)
    rt_k, rt_p = Runtime(device, paged_kernel=True), Runtime(device, paged_kernel=False)
    logits, dense = serving.make_prefill_step(cfg, rt_k)(
        params, torch.from_numpy(toks).to(device),
        last_pos=torch.from_numpy(last).to(device))
    nbmax = pc.n_blocks_for(S + steps, BLOCK_SIZE)
    caches = []
    for _ in range(2):
        paged = pc.paged_cache_init(cfg, SLOTS, BLOCK_SIZE, 1 + SLOTS * nbmax,
                                    nbmax, device)
        for row in range(SLOTS):
            ids = list(range(1 + row * nbmax, 1 + (row + 1) * nbmax))
            pc.set_block_table(paged, row, ids)
            pc.splice_prefill(paged, dense, row, row, ids)
        caches.append(paged)
    step_k = serving.make_serve_step(cfg, rt_k)
    step_p = serving.make_serve_step(cfg, rt_p)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    pos = torch.from_numpy(last + 1).to(device)
    worst = 0.0
    agree = 0
    for i in range(steps):
        nk, lk, caches[0] = step_k(params, caches[0], tok, pos)
        npl, lp, caches[1] = step_p(params, caches[1], tok, pos)
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError("kernel-path logits are not finite")
        rel = ((lk - lp).abs().max() / lp.abs().max()).item()
        worst = max(worst, rel)
        agree += int((nk == npl).sum())
        log(f"decode step {i}: max|dlogits|/max|logits| {rel:.3g}, "
            f"max|logits| {lp.abs().max().item():.4g}")
        tok, pos = nk[:, None], pos + 1           # teacher-force both paths
    bound = LOGIT_REL[cfg.compute_dtype]
    log(f"whole path ({cfg.compute_dtype} compute), kernel vs plain gather "
        f"over {steps} steps: worst {worst:.3g} (bound {bound}); greedy tokens "
        f"agree {agree}/{steps * SLOTS}")
    if worst > bound:
        raise AssertionError(f"kernel path logits differ by {worst:.3g}")


# ---------------------------------------------------------------------------
# phase 5: timing against the bound
# ---------------------------------------------------------------------------

def time_calls(torch, fn, n=50, flush_bytes=128 << 20):
    """Median ms of ``fn()`` over n calls, each timed with its own CUDA
    events, with a write of ``flush_bytes`` between calls so that every
    call finds L2 cold, as a decode step does."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        scratch.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_timing(torch, ops, ref, launches, err, n_layers, step_ms):
    import torch.nn.functional as F
    q, kp, vp, bt, pos = decode_case(torch, seed=2)
    B, H, hd = q.shape
    _, bs, K, _ = kp.shape
    G = H // K
    live = (pos.long() + 1).clamp(max=bt.shape[1] * bs)      # positions read
    n_t = int(live.sum())
    item = q.element_size()
    nbytes = (2 * n_t * K * hd * item + 2 * q.numel() * item
              + bt.numel() * 4 + pos.numel() * 4)
    flops = 4 * n_t * K * G * hd              # QK and PV, 2 flops per FMA
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations"

    T = bt.shape[1] * bs
    valid = torch.arange(T, device="cuda")[None, :] <= pos[:, None].long()

    def library():                          # gather + SDPA: the yardstick
        kd = kp[bt.long()].reshape(B, T, K, hd).transpose(1, 2)
        vd = vp[bt.long()].reshape(B, T, K, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=valid[:, None, None, :],
            enable_gqa=True)[:, :, 0]

    lib_err = (library().float() - ref(q, kp, vp, bt, pos).float()).abs().max().item()
    ms = time_calls(torch, lambda: ops.paged_attention(q, kp, vp, bt, pos))
    plain_ms = time_calls(torch, lambda: ref(q, kp, vp, bt, pos))
    library_ms = time_calls(torch, library)
    ms2 = time_calls(torch, lambda: ops.paged_attention(q, kp, vp, bt, pos))
    log(f"paged_decode_attention at the decode shape: kernel {ms:.4f} / "
        f"{ms2:.4f} ms, plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms "
        f"(max abs err vs plain {lib_err:.3g}), bound {bound_s * 1e3:.4f} ms by "
        f"{bound_by} ({nbytes} bytes, {flops} flops); {n_layers} launches take "
        f"{100 * n_layers * ms / step_ms:.1f} % of a {step_ms:.2f} ms decode step")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:88",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": library_ms}


def main() -> int:
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels, serving
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref as ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Runtime, make_runtime

    t_start = time.perf_counter()
    phase_card(torch, ops)
    err = phase_kernel(torch, ops, ref)
    rt = make_runtime("cuda")
    cfg = get_config(ARCH)
    params, launches, step_ms = phase_serve(torch, kernels, serve_mod, cfg, rt)
    phase_path(torch, cfg, params, Runtime, rt.device, serving)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32, _ = serve_mod.load_model(cfg32, rt, seed=0)
    phase_path(torch, cfg32, params32, Runtime, rt.device, serving)
    del params32
    row = phase_timing(torch, ops, ref, launches, err, cfg.n_layers, step_ms)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
