"""Gradient-transform chains and the chain -> engine compiler.

A port of ``repro.core.transform``.  A ``GradientTransform`` is an
``(init, update)`` pair over ``{dotted.path: Tensor}`` dicts, and
``chain()`` composes them left to right::

    tx = chain(add_decayed_weights(1e-4),
               normalize_by_global_norm(),
               trace(beta=0.9),
               scale_by_schedule(poly_power(1.6, 1000)))
    opt = compile_chain(tx, fused="multi_tensor")   # an Optimizer

Every norm-taking transform uses the engine's canonical ``leaf_sumsq``
reduction, so the numbers do not depend on the path.  Execution, as in
the JAX package:

  * ``match_chain`` recognizes whole chains shaped like the engine's
    kinds (``sngm_global``, ``sngm_per_tensor``, ``msgd``, ``lars``,
    ``lamb``), each optionally led by ``clip_by_global_norm`` (a clip
    round of its own) and, for the momentum kinds, with
    ``trace(nesterov=True)`` fused into the update pass.  A whole match
    compiles to the kind-level optimizer in ``core.optim``.
  * Otherwise ``plan_chain`` builds a ``SegmentPlan``: the longest suffix
    matching a kind becomes one engine segment (a clip just before it
    becomes its clip round, a TRAILING clip the deferred-apply pass), and
    the verifiably stateless stages before it run as plain nodes.
    ``compile_chain`` runs fusible plans on the engine under
    ``fused="multi_tensor"`` (``core.optim._plan_optimizer``).
  * A chain with no fusible tail runs on the **interpreter**: the
    transforms leaf by leaf in plain PyTorch, state a ``ChainOptState``,
    and ``w <- (w - u).to(w.dtype)``.  Asking for a fused mode then
    warns, naming the stage that blocked fusion.

``ema_params`` stages (shadow parameters) are position-independent: they
read the pre-step params and pass the updates through, so ``plan_chain``
gives each an ``ema`` node beside the fused tail, and the engine keeps
its shadow in resident f32 slots (``FlatOptState.e_flats``).

Weight decay is positional: ``add_decayed_weights`` before a normalize or
trust stage is coupled decay (the paper's), after it decoupled.  Stats
merge left to right (later transforms win): the normalize, clip and
trust stages report ``grad_norm`` of their input, ``trace`` reports
``update_norm`` of the momentum, ``scale_by_schedule`` reports ``lr``
and the pre-scaling ``update_norm``.  Counters are Python ints and
stats 0-dim f32 tensors.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.multi_tensor import (FlatGrads, bias_corrections,
                                           clip_leaf, clip_scale, global_norm,
                                           leaf_sumsq, trust_ratio as
                                           _trust_ratio)
from repro_torch.core.schedules import Schedule
from repro_torch.kernels.multi_tensor.ref import weak_scalar

Tree = Dict[str, torch.Tensor]
Stats = Dict[str, torch.Tensor]
InitFn = Callable[[Tree], Any]
UpdateFn = Callable[[Tree, Any, Tree], Tuple[Tree, Any, Stats]]


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    """One stage of an optimizer pipeline.

    ``update(updates, state, params) -> (updates, new_state, stats)``
    maps an update dict (initially the gradients) to a transformed one.
    ``meta`` carries the static parameters as ``(key, value)`` pairs for
    the pattern matcher; ``parts`` is non-empty only for ``chain()``
    results."""
    name: str
    init: InitFn
    update: UpdateFn
    meta: Tuple[Tuple[str, Any], ...] = ()
    parts: Tuple["GradientTransform", ...] = ()

    def get(self, key: str, default=None):
        return dict(self.meta).get(key, default)


# ---------------------------------------------------------------------------
# transform states
# ---------------------------------------------------------------------------

class EmptyState(NamedTuple):
    """Stateless transform marker."""


class TraceState(NamedTuple):
    momentum: Tree                 # f32, mirrors params


class ScaleByScheduleState(NamedTuple):
    count: int


class ScaleByAdamState(NamedTuple):
    count: int
    m: Tree                        # f32 first moment
    v: Tree                        # f32 second moment


class EmaParamsState(NamedTuple):
    ema: Tree                      # f32 shadow params, mirrors params


class ChainOptState(NamedTuple):
    """Interpreter-path optimizer state: the step counter and one
    sub-state per chained transform, in chain order."""
    step: int
    inner: Tuple[Any, ...]


def _zeros_f32_like(tree: Tree) -> Tree:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in tree.items()}


def _stateless(name: str, update_fn, meta=()) -> GradientTransform:
    def init(params):
        del params
        return EmptyState()

    def update(updates, state, params):
        out, stats = update_fn(updates, params)
        return out, state, stats

    return GradientTransform(name, init, update, tuple(meta))


# ---------------------------------------------------------------------------
# the transforms (each expression the JAX package's; a Python float meets a
# tensor as JAX's weakly typed float does, see ``weak_scalar``)
# ---------------------------------------------------------------------------

def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransform:
    """u <- u + wd * w, leaf by leaf in the incoming dtype: coupled decay
    before a normalize/trust stage, decoupled after it."""
    wd = float(weight_decay)

    def fn(updates, params):
        if wd == 0.0:
            return updates, {}
        return {k: g + weak_scalar(wd, params[k].dtype) * params[k]
                for k, g in updates.items()}, {}

    return _stateless("add_decayed_weights", fn,
                      meta=(("weight_decay", wd),))


def normalize_by_global_norm(eps: float = 1e-12) -> GradientTransform:
    """u <- u / (||u||_2 + eps) over the whole dict: Algorithm 1's
    normalization."""
    def fn(updates, params):
        del params
        gnorm = global_norm(updates)
        inv = 1.0 / (gnorm + eps)
        return {k: g.float() * inv for k, g in updates.items()}, \
            {"grad_norm": gnorm}

    return _stateless("normalize_by_global_norm", fn, meta=(("eps", eps),))


def normalize_per_tensor(eps: float = 1e-12) -> GradientTransform:
    """Each leaf divided by its own norm; reports the global norm."""
    def fn(updates, params):
        del params
        gnorm = global_norm(updates)

        def upd(g):
            n = torch.sqrt(leaf_sumsq(g))
            return g.float() * (1.0 / (n + eps))

        return {k: upd(g) for k, g in updates.items()}, {"grad_norm": gnorm}

    return _stateless("normalize_per_tensor", fn, meta=(("eps", eps),))


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    """u <- u * min(1, max_norm / ||u||), scaled in f32 and cast back."""
    max_norm = float(max_norm)

    def fn(updates, params):
        del params
        gnorm = global_norm(updates)
        scale = clip_scale(gnorm, max_norm)
        return {k: clip_leaf(g, scale) for k, g in updates.items()}, \
            {"grad_norm": gnorm}

    return _stateless("clip_by_global_norm", fn, meta=(("max_norm", max_norm),))


def trace(beta: float = 0.9, nesterov: bool = False) -> GradientTransform:
    """Polyak momentum (f32): m <- beta * m + u; output m, or
    beta * m + u for ``nesterov=True``."""
    beta = float(beta)

    def init(params):
        return TraceState(momentum=_zeros_f32_like(params))

    def update(updates, state, params):
        del params
        new_m = {k: beta * state.momentum[k] + u.float()
                 for k, u in updates.items()}
        out = ({k: beta * new_m[k] + u.float() for k, u in updates.items()}
               if nesterov else new_m)
        return out, TraceState(new_m), {"update_norm": global_norm(out)}

    return GradientTransform("trace", init, update,
                             (("beta", beta), ("nesterov", bool(nesterov))))


def trust_ratio(trust: float = 0.001, weight_decay: float = 0.0,
                eps: float = 1e-12) -> GradientTransform:
    """LARS's layer-wise scaling (pytorch-lars, as the paper used)::

        local = trust * ||w|| / (||g|| + wd * ||w|| + eps)    per tensor
        u <- local * (g + wd * w)        (local = 1 where ||w|| == 0)
    """
    trust, wd = float(trust), float(weight_decay)

    def fn(updates, params):
        def upd(g, w):
            g32 = g.float()
            wn = torch.sqrt(leaf_sumsq(w))
            gn = torch.sqrt(leaf_sumsq(g32))
            local = trust * wn / (gn + wd * wn + eps)
            local = torch.where(wn > 0, local, 1.0)
            return local * (g32 + weak_scalar(wd, w.dtype) * w)

        out = {k: upd(g, params[k]) for k, g in updates.items()}
        return out, {"grad_norm": global_norm(updates)}

    return _stateless("trust_ratio", fn,
                      (("trust", trust), ("weight_decay", wd), ("eps", eps)))


def scale_by_trust_ratio(eps: float = 0.0) -> GradientTransform:
    """LAMB's per-tensor rescale: u <- (||w|| / ||u||) * u, the ratio 1
    where either norm is zero."""
    eps = float(eps)

    def fn(updates, params):
        return {k: _trust_ratio(leaf_sumsq(params[k]), leaf_sumsq(u), eps)
                * u.float() for k, u in updates.items()}, {}

    return _stateless("scale_by_trust_ratio", fn, (("eps", eps),))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-6) -> GradientTransform:
    """Bias-corrected Adam direction (f32 moments): u <- m_hat /
    (sqrt(v_hat) + eps)."""
    b1, b2, eps = float(b1), float(b2), float(eps)

    def init(params):
        return ScaleByAdamState(count=0, m=_zeros_f32_like(params),
                                v=_zeros_f32_like(params))

    def update(updates, state, params):
        del params
        # divided as tensors on the updates' device: a CUDA division by a
        # CPU scalar multiplies by its reciprocal instead
        device = next(iter(updates.values())).device if updates else "cpu"
        bc1, bc2 = (b.to(device) for b in bias_corrections(state.count, b1, b2))
        new_m, new_v, out = {}, {}, {}
        for k, g in updates.items():
            g32 = g.float()
            new_m[k] = b1 * state.m[k] + (1 - b1) * g32
            new_v[k] = b2 * state.v[k] + (1 - b2) * torch.square(g32)
            out[k] = (new_m[k] / bc1) / (torch.sqrt(new_v[k] / bc2) + eps)
        return out, ScaleByAdamState(state.count + 1, new_m, new_v), {}

    return GradientTransform("scale_by_adam", init, update,
                             (("b1", b1), ("b2", b2), ("eps", eps)))


def scale_by_schedule(schedule: Schedule) -> GradientTransform:
    """u <- lr_t * u with lr_t from the schedule at the stage's own step
    count (a 0-dim f32 tensor, so it promotes a bf16 update to f32 as
    JAX's f32 array does).  Reports ``lr`` and the pre-scaling
    ``update_norm``."""
    def init(params):
        del params
        return ScaleByScheduleState(count=0)

    def update(updates, state, params):
        del params
        lr = schedule(state.count)
        out = {k: lr * u.float() for k, u in updates.items()}
        return out, ScaleByScheduleState(state.count + 1), \
            {"lr": lr, "update_norm": global_norm(updates)}

    return GradientTransform("scale_by_schedule", init, update,
                             (("schedule", schedule),))


def ema_params(decay: float = 0.999) -> GradientTransform:
    """Polyak-averaged shadow parameters for evaluation: keeps
    ``ema <- decay * ema + (1 - decay) * w`` (f32, two products and one
    add, each rounded, as the JAX package computes it) and passes the
    updates through.  The shadow is read from the chain state
    (``ChainOptState.inner[i].ema``)."""
    decay = float(decay)

    def init(params):
        # copy=True: .to(float32) of an f32 tensor returns the tensor
        # itself, and a shadow sharing the params' storage would move
        # with every parameter update
        return EmaParamsState(ema={k: p.detach().to(torch.float32, copy=True)
                                   for k, p in params.items()})

    def update(updates, state, params):
        new_ema = {k: decay * e + (1 - decay) * params[k].float()
                   for k, e in state.ema.items()}
        return updates, EmaParamsState(new_ema), {}

    return GradientTransform("ema_params", init, update, (("decay", decay),))


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def chain(*transforms: GradientTransform) -> GradientTransform:
    """Compose transforms left to right.  Nested chains are flattened, so
    the compiler always sees the primitive sequence."""
    parts: Tuple[GradientTransform, ...] = ()
    for t in transforms:
        parts += t.parts if t.parts else (t,)

    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(updates, state, params):
        stats: Stats = {}
        new_state = []
        for p, s in zip(parts, state):
            updates, ns, st = p.update(updates, s, params)
            stats.update(st)
            new_state.append(ns)
        return updates, tuple(new_state), stats

    return GradientTransform("chain", init, update, parts=parts)


def _parts(tx: GradientTransform) -> Tuple[GradientTransform, ...]:
    return tx.parts if tx.parts else (tx,)


# ---------------------------------------------------------------------------
# the whole-chain matcher
# ---------------------------------------------------------------------------

# Chain shapes the compiler recognizes, mapped to the engine's kinds.
# '?'-suffixed stages are optional: ``add_decayed_weights`` absent == wd 0,
# ``clip_by_global_norm`` absent == no clip round.  A nesterov trace fuses
# into the momentum kinds' update kernel; an adam eps <= 0 (pad invariance)
# or any other deviation falls through to the segment planner.
_PATTERNS = (
    ("sngm_global",
     ("clip_by_global_norm?", "add_decayed_weights?",
      "normalize_by_global_norm", "trace", "scale_by_schedule")),
    ("sngm_per_tensor",
     ("clip_by_global_norm?", "add_decayed_weights?", "normalize_per_tensor",
      "trace", "scale_by_schedule")),
    ("msgd",
     ("clip_by_global_norm?", "add_decayed_weights?", "trace",
      "scale_by_schedule")),
    ("lars",
     ("clip_by_global_norm?", "trust_ratio", "scale_by_schedule", "trace")),
    ("lamb",
     ("clip_by_global_norm?", "scale_by_adam", "add_decayed_weights?",
      "scale_by_trust_ratio", "scale_by_schedule")),
)


def _try_match(parts, pattern):
    """Return {name: transform} for a full match of ``pattern`` (with
    optional '?'-suffixed stages) against the chain parts, else None."""
    got: Dict[str, GradientTransform] = {}
    i = 0
    for want in pattern:
        optional = want.endswith("?")
        want = want.rstrip("?")
        if i < len(parts) and parts[i].name == want:
            got[want] = parts[i]
            i += 1
        elif not optional:
            return None
    return got if i == len(parts) else None


def _kind_params(kind: str, got: Dict[str, GradientTransform]
                 ) -> Dict[str, Any]:
    """The kind-level optimizer parameters of a pattern match."""
    kp = {"schedule": got["scale_by_schedule"].get("schedule"),
          "clip": None}
    if "clip_by_global_norm" in got:
        kp["clip"] = got["clip_by_global_norm"].get("max_norm")
    wd = (got["add_decayed_weights"].get("weight_decay")
          if "add_decayed_weights" in got else 0.0)
    if kind == "lamb":
        adam = got["scale_by_adam"]
        kp.update(b1=adam.get("b1"), b2=adam.get("b2"),
                  eps=adam.get("eps"), weight_decay=wd,
                  trust_eps=got["scale_by_trust_ratio"].get("eps"))
        return kp
    kp.update(beta=got["trace"].get("beta"),
              nesterov=bool(got["trace"].get("nesterov")),
              weight_decay=wd, eps=1e-12, trust=0.001)
    for src in ("normalize_by_global_norm", "normalize_per_tensor"):
        if src in got:
            kp["eps"] = got[src].get("eps")
    if "trust_ratio" in got:
        tr = got["trust_ratio"]
        kp.update(trust=tr.get("trust"),
                  weight_decay=tr.get("weight_decay"),
                  eps=tr.get("eps"))
    return kp


def match_chain(tx: GradientTransform) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Match a WHOLE chain onto a kind: ``(kind, params)``, for the
    momentum kinds params ``{schedule, beta, nesterov, weight_decay, eps,
    trust, clip}``, for ``lamb`` ``{schedule, b1, b2, eps, weight_decay,
    trust_eps, clip}``; None when the chain has none of the five shapes
    (``plan_chain`` may still fuse a suffix of it)."""
    parts = _parts(tx)
    for kind, pattern in _PATTERNS:
        got = _try_match(parts, pattern)
        if got is None:
            continue
        if kind == "lamb" and got["scale_by_adam"].get("eps") <= 0.0:
            return None   # engine pad invariance needs eps > 0
        return kind, _kind_params(kind, got)
    return None


# ---------------------------------------------------------------------------
# the segment planner: longest canonical suffix -> one fused engine segment
# ---------------------------------------------------------------------------

# transforms the planner may leave in a plan's prefix without probing:
# stateless by construction, with interpreter-exact leafwise updates
_STATELESS_NAMES = frozenset((
    "add_decayed_weights", "normalize_by_global_norm", "normalize_per_tensor",
    "clip_by_global_norm", "trust_ratio", "scale_by_trust_ratio"))

# per-stage state tags recorded in FlatOptState's ("chain", slots) form
_SLOT_TAGS = {"trace": "trace", "scale_by_schedule": "sched",
              "scale_by_adam": "adam", "ema_params": "ema"}

# kinds whose apply pass carries the schedule lr in the shared scalar ``c``
# — the only ones a TRAILING clip can fold into (the deferred-apply pass 3
# rescales c*u; lars bakes lr into its per-chunk coefficients and lamb into
# its scale_apply, so a suffix clip would double-count it)
_SUFFIX_CLIP_KINDS = ("sngm_global", "sngm_per_tensor", "msgd")


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """One node of a ``SegmentPlan``.

    ``op`` is ``"jnp"`` (a stateless prefix stage run leaf by leaf, as
    the interpreter runs it; zero launches), ``"ema"`` (an
    ``ema_params`` stage, kept in a resident slot and advanced on the
    pre-step params; zero launches) or
    ``"fused"`` (the engine-lowered tail segment).  The op names are the
    JAX package's, so plans compare equal across the two.  ``stages``
    are the chain indices the node covers; ``launches`` the node's
    kernel launches per dtype bucket and step."""
    op: str
    stages: Tuple[int, ...]
    label: str
    launches: int
    transform: Optional[GradientTransform] = None   # op == "jnp"
    kind: Optional[str] = None                      # op == "fused"
    kwargs: Tuple[Tuple[str, Any], ...] = ()        # op in ("fused", "ema")

    def arg(self, key: str, default=None):
        return dict(self.kwargs).get(key, default)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The segment compiler's IR: what ``compile_chain`` executes and
    what launch accounting and tests inspect.

    ``nodes`` run in chain order; ``slots`` tags every chain stage's
    state ("empty"|"trace"|"sched"|"adam"|"ema"): the ``FlatOptState``
    form a plan-compiled optimizer carries.  ``kind`` is the fused
    tail's engine kind, or None when the chain has no fusible suffix
    (then ``blocker`` names the (index, stage name) that broke fusion)."""
    nodes: Tuple[PlanNode, ...]
    slots: Tuple[str, ...]
    kind: Optional[str]
    blocker: Optional[Tuple[int, str]] = None

    @property
    def fused(self) -> Optional[PlanNode]:
        return next((n for n in self.nodes if n.op == "fused"), None)

    def launches_per_bucket(self) -> int:
        """Kernel launches per step and dtype bucket."""
        return sum(n.launches for n in self.nodes)

    def describe(self) -> str:
        return " -> ".join(n.label for n in self.nodes)


def _match_tail(parts) -> Optional[Tuple[str, Dict[str, Any], int,
                                         Optional[float]]]:
    """Longest suffix of ``parts`` matching a kind's pattern, optionally
    absorbing ONE trailing ``clip_by_global_norm`` into the kinds whose
    apply pass carries the lr (the deferred-apply suffix-clip pass).
    Returns (kind, got, start, suffix_clip) or None."""
    suffix_clip = None
    body = list(parts)
    if body and body[-1].name == "clip_by_global_norm":
        suffix_clip = body[-1].get("max_norm")
        body = body[:-1]
    patterns = (_PATTERNS if suffix_clip is None else
                tuple((k, p) for k, p in _PATTERNS
                      if k in _SUFFIX_CLIP_KINDS))
    for start in range(len(body)):
        for kind, pattern in patterns:
            got = _try_match(body[start:], pattern)
            if got is None:
                continue
            if kind == "lamb" and got["scale_by_adam"].get("eps") <= 0.0:
                continue
            return kind, got, start, suffix_clip
    return None


def _is_stateless(p: GradientTransform) -> bool:
    """Whether a stage can run as a prefix node: stateless by name, or its
    ``init`` returns ``EmptyState`` on an empty dict."""
    if p.name in _STATELESS_NAMES:
        return True
    try:
        return isinstance(p.init({}), EmptyState)
    except Exception:
        return False


def _fused_launches(kind: str, kp: Dict[str, Any], whole: bool) -> int:
    """Kernel launches per dtype bucket for one fused segment.  ``whole``
    marks a plan equivalent to a whole-chain match (run by the kind-level
    optimizer, where msgd runs its norm pass for the grad_norm stat; a
    plan-run msgd tail takes that stat from the prefix or the raw norm
    and skips pass 1)."""
    if kind == "lamb":
        return 2 + (1 if kp.get("clip") is not None else 0)
    n = 1                                        # fused update pass
    if kp.get("clip") is not None:
        n += 1                                   # raw-norm clip round
    if kp.get("suffix_clip") is not None:
        n += 1                                   # deferred-apply rescale
    if kind == "lars":
        n += 2                                   # ||g|| and ||w|| rounds
    elif kind in ("sngm_global", "sngm_per_tensor"):
        n += 1                                   # normalization norm round
    elif (whole and kp.get("clip") is None
          and kp.get("suffix_clip") is None):
        n += 1                                   # msgd grad_norm stat pass
    return n


def plan_chain(tx: GradientTransform) -> SegmentPlan:
    """Compile a chain to a ``SegmentPlan``: ``ema_params`` stages become
    ``ema`` nodes, the longest canonical suffix of what remains one fused
    engine segment, and the stages before it prefix nodes if they are
    verifiably stateless.  Always returns a plan; ``plan.kind is None``
    (with ``plan.blocker`` set) marks a chain that can only interpret."""
    parts = _parts(tx)
    slots = tuple(_SLOT_TAGS.get(p.name, "empty") for p in parts)

    def no_plan(blocker):
        nodes = tuple(PlanNode("jnp", (i,), f"interp:{p.name}", 0)
                      for i, p in enumerate(parts))
        return SegmentPlan(nodes=nodes, slots=slots, kind=None,
                           blocker=blocker)

    indexed = list(enumerate(parts))
    core = [(i, p) for i, p in indexed if p.name != "ema_params"]
    emas = [(i, p) for i, p in indexed if p.name == "ema_params"]
    if not core:
        return no_plan((indexed[-1][0], indexed[-1][1].name))
    tail = _match_tail([p for _, p in core])
    if tail is None:
        # fused tails end in schedule/trace(/clip): blame the last stage
        return no_plan((core[-1][0], core[-1][1].name))
    kind, got, start, suffix_clip = tail
    for i, p in core[:start]:
        if not _is_stateless(p):
            return no_plan((i, p.name))

    kp = _kind_params(kind, got)
    if suffix_clip is not None:
        kp["suffix_clip"] = suffix_clip
    whole = start == 0 and not emas and suffix_clip is None
    marks = "".join(
        ["+clip" if kp.get("clip") is not None else "",
         "+suffix_clip" if suffix_clip is not None else "",
         "+nesterov" if kp.get("nesterov") else ""])
    nodes = [PlanNode("jnp", (i,), f"jnp:{p.name}", 0, transform=p)
             for i, p in core[:start]]
    nodes += [PlanNode("ema", (i,), f"ema[{j}]:{p.get('decay')}", 0,
                       kwargs=(("decay", p.get("decay")),))
              for j, (i, p) in enumerate(emas)]
    nodes.append(PlanNode(
        "fused", tuple(i for i, _ in core[start:]), f"fused:{kind}{marks}",
        _fused_launches(kind, kp, whole), kind=kind,
        kwargs=tuple(kp.items())))
    nodes.sort(key=lambda n: n.stages[0])
    return SegmentPlan(nodes=tuple(nodes), slots=slots, kind=kind)


# ---------------------------------------------------------------------------
# the interpreter and the compiler
# ---------------------------------------------------------------------------

def interpreter_step(tx: GradientTransform, grads, state: ChainOptState,
                     params: Optional[Tree]):
    """One interpreter step of a chain: the reference every compiled path
    is held against.  Returns (new_params, new_state, stats)."""
    if params is None:
        raise TypeError(
            "interpreter-run chains carry no resident parameter buffers; "
            "build the TrainState with params (opt.init_state does this — "
            "only FlatOptState owners set params=None)")
    if isinstance(grads, FlatGrads):
        grads = grads.tree
    updates, inner, stats = tx.update(grads, state.inner, params)
    new_p = {k: (w - updates[k]).to(w.dtype) for k, w in params.items()}
    stats = dict(stats)
    if "grad_norm" not in stats:
        stats["grad_norm"] = global_norm(grads)
    if "update_norm" not in stats:
        stats["update_norm"] = global_norm(updates)
    if "lr" not in stats:
        stats["lr"] = torch.tensor(float("nan"))
    return new_p, ChainOptState(state.step + 1, inner), stats


def _names(tx: GradientTransform) -> Tuple[str, ...]:
    return tuple(p.name for p in _parts(tx))


def compile_chain(tx: GradientTransform, *, fused: Optional[str] = None,
                  name: Optional[str] = None, interpret: bool = False):
    """Compile a chain into an ``Optimizer``.

    A whole-chain shape (``match_chain``) compiles onto the kind-level
    optimizer in every execution mode (``fused=None``, ``"per_leaf"``,
    ``"multi_tensor"``).  Other chains go through ``plan_chain``: a plan
    with a fused tail runs on the engine under ``fused="multi_tensor"``
    and on the interpreter otherwise; a chain with no fusible tail runs
    on the interpreter (``ChainOptState``).  Asking for a fused mode that
    the chain cannot take warns and falls back to the interpreter.
    ``interpret=True`` runs ANY chain on the interpreter.  The optimizer
    carries its ``SegmentPlan`` as ``opt.plan`` (None under
    ``interpret=True``)."""
    from repro_torch.core import optim   # deferred: optim builds chains here

    plan = None if interpret else plan_chain(tx)
    matched = None if interpret else match_chain(tx)
    if matched is not None:
        kind, kp = matched
        if kind == "lamb":
            opt = optim._lamb_optimizer(
                kp["schedule"], b1=kp["b1"], b2=kp["b2"], eps=kp["eps"],
                weight_decay=kp["weight_decay"], trust_eps=kp["trust_eps"],
                clip=kp["clip"], fused=fused, name=name or kind)
        else:
            opt = optim._kind_optimizer(
                kind, kp["schedule"], beta=kp["beta"],
                nesterov=kp["nesterov"], weight_decay=kp["weight_decay"],
                eps=kp["eps"], trust=kp["trust"], clip=kp["clip"],
                fused=fused, name=name or kind)
        return dataclasses.replace(opt, plan=plan)
    if plan is not None and plan.kind is not None:
        if fused == "multi_tensor":
            return optim._plan_optimizer(
                tx, plan, name=name or f"chain[{plan.kind}]")
        if fused is not None:
            warnings.warn(
                f"chain {_names(tx)} compiles to the segment plan "
                f"[{plan.describe()}], which runs only on the multi-tensor "
                f"engine; fused={fused!r} is ignored and the chain runs on "
                f"the jnp interpreter", UserWarning, stacklevel=2)
    elif fused is not None:
        if plan is not None and plan.blocker is not None:
            i, nm = plan.blocker
            detail = (f": stage {i} ({nm!r}) blocks segment fusion and the "
                      f"plan degenerates to [{plan.describe()}]")
        else:
            detail = ""
        warnings.warn(
            f"chain {_names(tx)} does not match any fused kind{detail}; "
            f"fused={fused!r} is ignored and the chain runs on the jnp "
            f"interpreter", UserWarning, stacklevel=2)

    def init(params):
        return ChainOptState(step=0, inner=tx.init(params))

    @torch.no_grad()
    def step_fn(grads, state, params):
        return interpreter_step(tx, grads, state, params)

    return optim.Optimizer(name=name or "chain", init=init, step=step_fn,
                           plan=plan)


def as_optimizer(opt_or_tx, *, fused: Optional[str] = None):
    """An ``Optimizer`` as it is, or a ``GradientTransform`` chain
    compiled on the spot (what ``make_train_step`` applies)."""
    if isinstance(opt_or_tx, GradientTransform):
        return compile_chain(opt_or_tx, fused=fused)
    return opt_or_tx
