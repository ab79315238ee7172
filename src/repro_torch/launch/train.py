"""Training launcher: SNGM (or a baseline) on a decoder LM.

A port of ``repro.launch.train`` with its flags and defaults and the
same stdout line format, so the two launchers' logs diff line by line.
It adds:

  * ``--device``: ``cuda`` (the default) or ``cpu``.  Without a card it
    raises unless ``--device cpu`` is given.
  * ``--seed``: the weights are ``materialize(defs, PRNGKey(seed))`` and
    the batches ``SyntheticLM(..., seed=seed)``, drawn as the JAX package
    draws them (``repro_torch.prng``); at ``--seed 0`` they are the JAX
    launcher's (it always uses seed 0), so the two launchers' lines
    can be diffed.

Every optimizer of the JAX launcher runs (sngm, sngd, msgd, lars,
lamb), in each execution mode it offers: ``--fused none``,
``multi_tensor`` (all five) and ``per_leaf`` (sngm, sngd, lars).

Checkpoints and resume are the JAX launcher's, in its on-disk format
(``repro_torch.checkpoint``), so either launcher resumes the other's
runs: ``--ckpt DIR`` saves {"params", "opt"} at the end (the pytree
form of the state: a resident state is saved as its momentum or chain
state, never its flat buffers) and ``train_meta.json`` (the schedule
horizon and the ``OptimizerSpec``); ``--resume`` restores from DIR in
whichever state form this run uses, adopts the saved spec and horizon,
and continues from the saved step; ``--total-steps`` pins the schedule
horizon across a save/resume split; ``--save-every K`` saves into
step-named dirs under DIR (``step_00000010/``, ``latest``, pruned by
``--keep-last-n``); ``--async-save`` commits on a background thread
after a blocking device-to-host copy.

Data: by default ``SyntheticLM.batch_at(t)``, which depends on ``t``
and ``--seed`` alone, so a resumed run reads the batches of the
uninterrupted one (give it the same ``--seed``).  An encoder-decoder's
batches add (B, encoder_len, d_model) fp32 frame embeddings drawn from
``PRNGKey(t)`` (``EncoderFrames``: the JAX launcher's draw, keyed by the
step alone and not by ``--seed``); a ``--data-dir`` pack must carry an
``encoder_embeds`` field for it, which the loader passes through.
``--data-dir`` trains
from an on-disk ``repro-data-pack`` (``python -m repro_torch.data.pack``)
through the ``StreamingLoader`` (seeded by ``--seed``; at 0 it is the
JAX launcher's stream) with ``--prefetch``-deep host-to-device prefetch
(``PrefetchIterator``: pinned batches copied on a side stream; 0 places
each batch on the training thread).  The sequence length is the pack's
``seq_len``.  The cursor of the next batch training consumes rides
every checkpoint (``loader_state``: the prefetcher's snapshot, never the
loader's run-ahead position), so ``--resume`` re-seeks the stream and
batch ``t`` after a resume is bitwise batch ``t`` of an uninterrupted
run, whichever launcher wrote the checkpoint.

``--ema-decay D`` keeps shadow parameters (``sngm(ema_decay=D)``; the
other optimizers' builders take no such keyword and ignore it, as in
the JAX launcher): resident f32 slots on the engine, saved in the
checkpoint as the chain's ``ema_params`` state and restored with it.
Not ported yet, and refused with a clear error: meshes
(``--model-axis``, ``--pod-axis``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --device cpu --steps 4 --batch 4 --seq 32 \\
        --optimizer sngm --fused multi_tensor --log-every 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from repro_torch import prng
from repro_torch.checkpoint import (AsyncCheckpointer, check_loadable,
                                    load_checkpoint, load_loader_state,
                                    resolve_checkpoint, save_checkpoint,
                                    step_dir)
from repro_torch.checkpoint.io import archive_keys
from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.core.optim import (FlatOptState, LambState, OptimizerSpec,
                                    TrainState, builder_accepts, lamb_state_of,
                                    make_optimizer, optimizer_names, to_pytree)
from repro_torch.data import (DiskShardedSource, LoaderState,
                              PrefetchIterator, StreamingLoader, SyntheticLM)
from repro_torch.data.prefetch import HostToDevice
from repro_torch.models import count, make_runtime, materialize, model_defs
from repro_torch.tracker import (CompositeTracker, JsonlTracker, MemoryTracker,
                                 StdoutTracker)
from repro_torch.tracker.callbacks import PrefetchMonitor, StepTimer
from repro_torch.training import make_train_step, run_steps

NOT_PORTED = "is not ported yet (ROADMAP.md Queue A)"
DEFAULT_OPTIMIZER = "sngm"


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--optimizer", default=DEFAULT_OPTIMIZER,
                    choices=list(optimizer_names()))
    ap.add_argument("--fused", default="none",
                    choices=["none", "per_leaf", "multi_tensor"],
                    help="optimizer execution path: plain PyTorch (none), "
                         "one CUDA kernel per tensor (per_leaf: sngm, sngd, "
                         "lars), or the dtype-bucketed multi-tensor engine "
                         "with its CUDA kernels (multi_tensor; 2 launches "
                         "per step for sngm and lamb)")
    ap.add_argument("--lr", type=float, default=1.6)
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--nesterov", action="store_true",
                    help="look-ahead momentum (sngm, msgd); fused into the "
                         "update pass, so the launch count is unchanged")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true",
                    help="restore {params, opt} from --ckpt (written by either "
                         "package, any state form) and continue from the "
                         "saved step, with the saved optimizer spec and "
                         "schedule horizon")
    ap.add_argument("--total-steps", type=int, default=0,
                    help="schedule horizon (0 = --steps); set this when a "
                         "run is split across save/resume segments so every "
                         "segment builds the same poly_power schedule")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint every K steps into step-named dirs "
                         "under --ckpt (step_00000010/, latest symlink); "
                         "0 = a single final save at --ckpt itself")
    ap.add_argument("--keep-last-n", type=int, default=0,
                    help="with --save-every: prune committed step_* dirs "
                         "beyond the newest N (0 = keep all; symlink "
                         "targets survive)")
    ap.add_argument("--async-save", action="store_true",
                    help="commit checkpoints on a background thread; the "
                         "step pays only the device->host copy")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-jsonl", default="",
                    help="append per-step metrics (loss, grad_norm, lr, "
                         "wall-clock, tokens/sec) as JSON lines to this path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-dir", default="",
                    help="train from an on-disk repro-data-pack dataset "
                         "(python -m repro_torch.data.pack) via the sharded "
                         "StreamingLoader; its LoaderState rides every "
                         "checkpoint for exact-batch resume.  Default: the "
                         "synthetic batch_at stream")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="host->device prefetch depth for --data-dir runs "
                         "(0 = synchronous next(); 2 = double buffering)")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="keep an exponential moving average of the params "
                         "(0 = off); on the resident path the shadow params "
                         "live in the flat f32 EMA slots and ride the "
                         "checkpoint like any other optimizer state")
    # accepted so that the JAX launcher's command lines give a clear error
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--pod-axis", type=int, default=1)
    args = ap.parse_args(argv)
    if args.model_axis != 1 or args.pod_axis != 1:
        ap.error(f"a mesh (--model-axis, --pod-axis) {NOT_PORTED}")
    return args


def spec_from_args(args, horizon: int) -> OptimizerSpec:
    """The optimizer spec the flags give, keyword for keyword the JAX
    launcher's (each optimizer takes the flags its builder accepts)."""
    kwargs = {"schedule": {"name": "poly_power",
                           "kwargs": {"lr0": args.lr, "total_steps": horizon,
                                      "power": 1.1}}}
    for k, v in (("beta", args.beta), ("weight_decay", args.weight_decay),
                 ("nesterov", args.nesterov),
                 ("ema_decay", args.ema_decay or None),
                 ("fused", None if args.fused == "none" else args.fused)):
        if builder_accepts(args.optimizer, k):
            kwargs[k] = v
    return OptimizerSpec(args.optimizer, kwargs)


@dataclasses.dataclass
class Plan:
    """The run's identity: its optimizer spec and schedule horizon (on
    ``--resume`` the checkpoint's, as the JAX launcher adopts them), the
    checkpoint to resume, and the warnings to print."""
    spec: OptimizerSpec
    horizon: int
    resume_path: str = ""
    notes: List[str] = dataclasses.field(default_factory=list)


def plan_run(args) -> Plan:
    fused = None if args.fused == "none" else args.fused
    horizon = args.total_steps or args.steps
    saved_meta, resume_path, notes = {}, "", []
    if args.resume:
        if not args.ckpt:
            raise SystemExit("--resume requires --ckpt")
        # --ckpt may be the checkpoint itself or the BASE of a
        # --save-every step_* family; follow latest/newest committed
        resume_path = resolve_checkpoint(args.ckpt)
        # the schedule horizon is part of the run's identity: adopt the
        # saved one when --total-steps is omitted, warn on a mismatch
        tm_path = os.path.join(args.ckpt, "train_meta.json")
        if os.path.exists(tm_path):
            with open(tm_path) as f:
                saved_meta = json.load(f)
            saved_horizon = saved_meta.get("total_steps")
            if saved_horizon:
                if not args.total_steps:
                    horizon = saved_horizon
                elif saved_horizon != horizon:
                    notes.append(f"[train] WARNING: --total-steps {horizon} != "
                                 f"checkpoint horizon {saved_horizon}; the lr "
                                 f"schedule will not match the original run")
    if args.resume and saved_meta.get("optimizer_spec"):
        # the optimizer's identity travels with the run; only the
        # execution mode (--fused) stays a per-run choice, and the
        # horizon is re-pinned in case --total-steps forced another
        spec = OptimizerSpec.from_json(saved_meta["optimizer_spec"])
        if spec.name != args.optimizer and args.optimizer != DEFAULT_OPTIMIZER:
            notes.append(f"[train] WARNING: --optimizer {args.optimizer} "
                         f"ignored; resuming the checkpoint's {spec.name!r} "
                         f"spec")
        kwargs = dict(spec.kwargs)
        if builder_accepts(spec.name, "fused"):
            kwargs["fused"] = fused
        sched = dict(kwargs["schedule"])
        skw = dict(sched.get("kwargs", {}))
        if "total_steps" in skw and skw["total_steps"] != horizon:
            skw["total_steps"] = horizon
            sched["kwargs"] = skw
            kwargs["schedule"] = sched
        spec = OptimizerSpec(spec.name, kwargs)
    else:
        spec = spec_from_args(args, horizon)
    return Plan(spec, horizon, resume_path, notes)


class PackStream:
    """``--data-dir``: the pack's ``StreamingLoader`` (seeded by
    ``--seed``), read during each ``train`` call through a
    ``--prefetch``-deep ``PrefetchIterator`` that stages every batch on
    the run's device, or placed on the training thread with
    ``--prefetch 0``.  ``need``: fields the pack must carry (an
    encoder-decoder's ``encoder_embeds``).  ``state`` is the cursor of
    the next batch training
    consumes, whatever the worker has read ahead; after a ``train`` call
    the loader is left at that cursor."""

    def __init__(self, args, cfg, device: torch.device,
                 need: Sequence[str] = ()):
        source = DiskShardedSource(args.data_dir)
        v = source.meta.get("vocab_size")
        if v is not None and v != cfg.vocab_size:
            raise SystemExit(f"--data-dir vocab_size {v} != model vocab "
                             f"{cfg.vocab_size} ({cfg.name})")
        for field in need:
            if field not in source.fields:
                raise SystemExit(f"--data-dir: {cfg.name} needs a {field!r} "
                                 f"field in the dataset")
        self.seq = int(source.meta.get("seq_len", args.seq))
        self.loader = StreamingLoader(source, args.batch, seed=args.seed)
        self.depth = args.prefetch
        # one side stream and pinned ring for the run: depth batches
        # queued, one in the consumer's hands, one being staged
        self.place = HostToDevice(device, slots=max(self.depth, 0) + 2)
        self.prefetcher: Optional[PrefetchIterator] = None

    @property
    def state(self) -> LoaderState:
        return (self.prefetcher or self.loader).state

    def seek(self, state: LoaderState) -> None:
        self.loader.seek(state)

    def start(self):
        """The batch iterator of one ``train`` call."""
        if self.depth > 0:
            self.prefetcher = PrefetchIterator(self.loader, self.depth,
                                               self.place)
            return self.prefetcher
        return (self.place(b).wait() for b in self.loader)

    def stop(self) -> None:
        """Join the prefetch worker (re-raising its failure) and seek the
        loader back to the cursor training reached."""
        pf, self.prefetcher = self.prefetcher, None
        if pf is not None:
            try:
                pf.close()
            finally:
                self.loader.seek(pf.state)

    def close(self) -> None:
        self.stop()
        self.loader.close()


class EncoderFrames:
    """An encoder-decoder's synthetic batches: ``SyntheticLM``'s, each with
    (B, encoder_len, d_model) fp32 frame embeddings
    ``normal(PRNGKey(t), ...)`` on the run's device: the JAX launcher's
    ``jax.random.normal`` draw (keyed by the step alone) within
    ``prng.NORMAL_ULP`` ulps."""

    def __init__(self, lm: SyntheticLM, cfg, batch: int, device: torch.device):
        self.lm, self.device = lm, device
        self.shape = (batch, cfg.encoder_len, cfg.d_model)

    def batch_at(self, t: int):
        b = self.lm.batch_at(t)
        b["encoder_embeds"] = prng.normal(prng.PRNGKey(t), self.shape,
                                          self.device)
        return b


@dataclasses.dataclass
class Run:
    """What ``build`` sets up: the step function, the state, the data
    (``SyntheticLM`` or ``EncoderFrames``, read by ``batch_at``, or a
    ``PackStream``) and the sequence length its batches have."""
    cfg: Any
    opt: Any
    state: TrainState
    step: Any
    data: Union[SyntheticLM, EncoderFrames, PackStream]
    n_params: int
    seq: int

    def loader_state(self) -> Optional[LoaderState]:
        """The cursor a checkpoint saves: the next batch training will
        consume (None for ``SyntheticLM``, which needs none)."""
        return self.data.state if isinstance(self.data, PackStream) else None


def build(args, spec: Optional[OptimizerSpec] = None) -> Run:
    """Config, runtime, random weights, optimizer, train step and data,
    as the launcher builds them; the optimizer from ``spec``, or from
    the flags."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_variant(cfg)
    rt = make_runtime(args.device, remat=not args.reduced)
    if args.data_dir:
        data = PackStream(args, cfg, rt.device, need=(
            ("encoder_embeds",) if cfg.is_encoder_decoder else ()))
        seq = data.seq
    else:
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                           branching=4, device=rt.device)
        if cfg.is_encoder_decoder:
            data = EncoderFrames(data, cfg, args.batch, rt.device)
        seq = args.seq
    defs = model_defs(cfg)
    params = materialize(defs, prng.PRNGKey(args.seed), rt.device)
    if spec is None:
        spec = spec_from_args(args, args.total_steps or args.steps)
    opt = make_optimizer(spec)
    state = opt.init_state(params)
    del params
    step = make_train_step(cfg, rt, opt, n_micro=args.n_micro)
    return Run(cfg, opt, state, step, data, count(defs), seq)


def _restore(path: str, params, state):
    """Restore {"params", "opt"} into the live state's own tensors, in
    whichever state form it has: the archive holds the pytree form
    (``OptState`` or ``ChainOptState``, whichever package wrote it), the
    template is ``to_pytree`` of the live state (views into a resident
    state's buffers, the EMA shadows' into ``e_flats``), and each leaf is
    copied into its tensor as it is read, so a restore needs no second
    copy of the state.  Returns
    ({"params", "opt"}, step).

    A torn directory (no ``COMMIT`` marker and not a demonstrably
    complete legacy save) is rejected up front, and so is an archive of
    the JAX package's flat buffers (``p_flats``), a form its launcher
    does not write."""
    try:
        check_loadable(path)
    except ValueError as e:
        raise SystemExit(f"--resume: {e}") from e
    if any("p_flats" in k for k in archive_keys(path)):
        raise SystemExit(f"--resume: {path!r} holds a resident state's flat "
                         f"buffers; save its to_pytree form instead")
    restored, step = load_checkpoint(
        path, {"params": params, "opt": to_pytree(state)}, into=True)
    opt = restored["opt"]
    if isinstance(state, FlatOptState):
        opt = dataclasses.replace(state, step=opt.step)
    elif isinstance(state, LambState):
        opt = lamb_state_of(opt)
    return {"params": restored["params"], "opt": opt}, step


def resume(run: Run, path: str) -> int:
    """Restore ``run.state`` from the checkpoint at ``path``, and seek a
    ``--data-dir`` stream to its ``loader_state``; returns the step to
    continue from."""
    restored, start = _restore(path, run.state.params_view,
                               run.state.opt_state)
    run.state = TrainState.wrap(restored["params"], restored["opt"])
    if isinstance(run.data, PackStream):
        ls = load_loader_state(path)
        if ls is None:
            print("[train] WARNING: checkpoint carries no loader_state; "
                  "the data stream restarts from the beginning")
        else:
            run.data.seek(LoaderState.from_dict(ls))
    return start


class Saves:
    """``--ckpt``, ``--save-every``, ``--keep-last-n``, ``--async-save``:
    the periodic step hook and the final save, as the JAX launcher makes
    them.  Each save holds the live state's pytree form and what
    ``loader_state()`` returns then (``Run.loader_state``: the cursor of
    the next batch training consumes, or None)."""

    def __init__(self, args, plan: Plan,
                 loader_state: Callable[[], Optional[LoaderState]] = lambda: None):
        self.args, self.plan = args, plan
        self.loader_state = loader_state
        self.saver = (AsyncCheckpointer() if (args.ckpt and args.async_save)
                      else None)
        self.step_hook = None
        if args.ckpt and args.save_every > 0:
            # train_meta.json up front, so an interrupted run is already
            # resumable from its newest periodic save
            self.write_meta()
            self.step_hook = self._hook

    def train_meta(self):
        return {"total_steps": self.plan.horizon,
                "optimizer": self.plan.spec.name, "lr": self.args.lr,
                "optimizer_spec": self.plan.spec.to_json()}

    def write_meta(self):
        os.makedirs(self.args.ckpt, exist_ok=True)
        with open(os.path.join(self.args.ckpt, "train_meta.json"), "w") as f:
            json.dump(self.train_meta(), f)

    def save_step(self, step_no: int, state: TrainState):
        tree = {"params": state.params_view, "opt": state.opt_state}
        # keep_last_n=0 still maintains the latest/best symlinks
        kw = dict(loader_state=self.loader_state(),
                  keep_last_n=self.args.keep_last_n)
        dest = step_dir(self.args.ckpt, step_no)
        if self.saver is not None:
            self.saver.save(dest, tree, step_no, **kw)
        else:
            save_checkpoint(dest, tree, step_no, **kw)

    def _hook(self, t: int, state: TrainState):
        if (t + 1) % self.args.save_every == 0:
            self.save_step(t + 1, state)

    def finish(self, state: TrainState, start: int):
        """The final save (into the step-named family, or at --ckpt
        itself), train_meta.json, then drain the async saves."""
        args = self.args
        if args.ckpt:
            final_step = max(start, args.steps)
            in_family = args.save_every > 0 or (
                os.path.isdir(args.ckpt)
                and resolve_checkpoint(args.ckpt) != args.ckpt)
            if in_family:
                # periodic mode, or a resume whose --ckpt is the BASE of a
                # family: join it rather than clobber the base
                hook_saved = (args.save_every > 0 and final_step > start
                              and final_step % args.save_every == 0)
                if not hook_saved:
                    self.save_step(final_step, state)
            else:
                save_checkpoint(args.ckpt, {"params": state.params_view,
                                            "opt": state.opt_state},
                                step=final_step,
                                loader_state=self.loader_state())
            self.write_meta()
            print(f"[train] checkpoint -> {args.ckpt}")
        if self.saver is not None:
            self.saver.close()           # drain pending commits, re-raise


def fmt(t, m):
    return (f"  step {t:5d} loss={m['loss']:.4f} "
            f"||g||={m.get('grad_norm', float('nan')):.3f} "
            f"lr={m.get('lr', float('nan')):.4f} "
            f"({m.get('it_per_s', 0.0):.2f} it/s)")


def train(args, run: Run, start: int = 0, step_hook=None):
    """Run steps ``start`` to ``args.steps``; returns (final state,
    MemoryTracker).  A ``--data-dir`` run reads its stream from where
    ``run.data`` stands, prints the input-stall line under prefetch, and
    joins the prefetch worker before it returns or raises."""
    mem = MemoryTracker()
    backends = [mem, StdoutTracker(every=args.log_every, fmt=fmt)]
    if args.metrics_jsonl:
        backends.append(JsonlTracker(args.metrics_jsonl))
    callbacks = [StepTimer(tokens_per_step=args.batch * run.seq)]
    pack = isinstance(run.data, PackStream)
    batches = run.data.start() if pack else run.data.batch_at
    pf = run.data.prefetcher if pack else None
    if pf is not None:
        callbacks.append(PrefetchMonitor(pf))
    try:
        state = run_steps(run.step, run.state, batches, args.steps,
                          start=start, tracker=CompositeTracker(backends),
                          log_every=args.log_every, callbacks=callbacks,
                          step_hook=step_hook)
    finally:
        if pack:
            run.data.stop()
    if pf is not None:
        c = pf.counters()
        print(f"[train] input stall "
              f"{c['input_stall_s_per_step'] * 1e3:.2f} ms/step, "
              f"prefetch depth avg {c['prefetch_depth_avg']:.2f}")
    return state, mem


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    args = parse_args(argv)
    plan = plan_run(args)
    run = build(args, plan.spec)
    print(f"[train] {run.cfg.name}: {run.n_params:,} params on 1 device(s) "
          f"across 1 process(es)")
    for note in plan.notes:
        print(note)
    start = 0
    if args.resume:
        start = resume(run, plan.resume_path)
        print(f"[train] resumed {plan.resume_path} at step {start}")
    saves = Saves(args, plan, run.loader_state)
    try:
        state, mem = train(args, run, start, saves.step_hook)
        saves.finish(state, start)
    finally:
        if isinstance(run.data, PackStream):
            run.data.close()
    return mem.series("loss")


if __name__ == "__main__":
    main()
