"""Checkpoints: a port of ``repro.checkpoint.io`` on a single device, in
its on-disk format 3, so a checkpoint written by either package loads in
the other.

A checkpoint is a directory holding ``shard_00000.npz`` (one array per
leaf) and ``meta.json`` (``{"step", "n_leaves", "format": 3,
"dtypes"}``, plus the optional ``loader_state`` and ``metric``).  The
archive keys are the JAX package's ``tree_flatten_with_path`` strings,
joined by ``/``: a dict key as itself, a NamedTuple field as ``.name``,
a tuple position as ``[i]``.  The port keys its trees with dotted paths
(``blocks.L0.attn.wq``), which become ``blocks/L0/attn/wq``, and leaves
are written in the JAX tree's order (dict keys sorted at every level).
State forms map to the JAX package's pytree forms first (``to_pytree``):
a resident ``FlatOptState`` is saved as its ``OptState`` or
``ChainOptState`` (never its flat buffers), and a plain-path
``LambState`` as the interpreter's ``ChainOptState``.  So a launcher run
saves ``params/<a>/<b>``, ``opt/.step``, ``opt/.momentum/<a>/<b>``
(the momentum kinds), ``opt/.inner/[0]/.count``,
``opt/.inner/[0]/.m/...``, ``opt/.inner/[0]/.v/...``,
``opt/.inner/[3]/.count`` (LAMB), or ``opt/.inner/[2]/.momentum/...``,
``opt/.inner/[3]/.count``, ``opt/.inner/[4]/.ema/...`` (SNGM with
``--ema-decay``: the resident ``e_flats`` as the chain's ``ema_params``
state, f32), exactly as the JAX launcher does.
Integer counters are written as 0-d int32 arrays.

Dtype fidelity without ``ml_dtypes``: bfloat16 leaves are stored as
their uint16 bits, with the true dtype in the ``dtypes`` sidecar; a load
views the bits back as ``torch.bfloat16``, then casts every leaf to the
template's dtype.  A pre-sidecar archive whose
bf16 leaves were written as raw void records is rescued through the
template's dtype.

Atomic commit, torn-save rejection, interrupted-swap recovery, the
clobber guards, step-named families with ``latest``/``best`` symlinks
and retention, and ``AsyncCheckpointer`` are the JAX package's, line
for line.  The async device-to-host snapshot is a blocking copy into
pageable host memory: when ``save()`` returns, every byte is on the
host, so the next step may rewrite the resident buffers in place.  The multi-host barrier
(``_multihost_save``) is not ported (ROADMAP.md Queue A9).
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.multi_tensor import dtype_name

COMMIT_MARKER = "COMMIT"
SHARD = "shard_00000.npz"          # one process: rank 0's shard

# bfloat16: numpy's .npy format cannot carry it, so its bits are stored
# as uint16 (viewed through int16 on the torch side)
BF16 = "bfloat16"


def is_committed(path: str) -> bool:
    """True iff ``path`` holds a fully committed checkpoint (the marker is
    the LAST thing a save produces before the atomic rename)."""
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def _recover_interrupted_swap(path: str) -> None:
    """A crash between the swap's rename and replace steps leaves ``path``
    missing while a FULLY COMMITTED staging (new save) or backup (old
    save) directory survives.  Move the best committed candidate back
    into place — newest first — so neither save-over nor resume ever
    deletes or overlooks the only committed copy on disk."""
    if os.path.exists(path):
        return
    for cand in (f"{path}.tmp-staging", f"{path}.tmp-old"):
        if os.path.isdir(cand) and is_committed(cand):
            os.replace(cand, path)
            return


def check_loadable(path: str) -> None:
    """Raise unless ``path`` is safe to load: committed (marker present),
    or a LEGACY pre-marker checkpoint that is demonstrably complete —
    the old writer produced meta.json after the shard, so a markerless
    dir whose meta ``n_leaves`` matches the archive's key count was
    finished.  Anything else is a torn/interrupted save.  Recovers a
    crash-interrupted swap first (see ``_recover_interrupted_swap``)."""
    _recover_interrupted_swap(path)
    if is_committed(path):
        return
    meta_p = os.path.join(path, "meta.json")
    shard_p = os.path.join(path, SHARD)
    if os.path.exists(meta_p) and os.path.exists(shard_p):
        try:
            with open(meta_p) as f:
                n_meta = json.load(f).get("n_leaves")
            n_arch = len(np.load(shard_p).files)
        except Exception:
            n_meta, n_arch = None, -1
        if n_meta is not None and n_meta == n_arch:
            return                              # legacy-complete
    raise ValueError(
        f"checkpoint at {path!r} has no {COMMIT_MARKER} marker and is not "
        f"a complete legacy save: the write was interrupted before "
        f"committing (or the directory is not a checkpoint); refusing to "
        f"load a torn save")


# ---------------------------------------------------------------------------
# the JAX package's key paths over the port's trees
# ---------------------------------------------------------------------------

def _pytree_form(node):
    """A resident ``FlatOptState`` or a ``LambState`` as the JAX
    package's pytree form; anything else as it is."""
    from repro_torch.core.optim import FlatOptState, LambState, to_pytree
    if isinstance(node, (FlatOptState, LambState)):
        return to_pytree(node)
    return node


def _children(node):
    """(key-path parts, child) pairs of an inner node in the JAX tree's
    order, or None for a leaf.  A dict's dotted keys split into nested
    levels, sorted per level as ``jax.tree_util`` sorts dict keys."""
    if isinstance(node, dict):
        keys = sorted(node, key=lambda k: tuple(str(k).split(".")))
        return [(str(k).split("."), node[k]) for k in keys]
    if hasattr(node, "_fields"):                    # NamedTuple
        return [([f".{f}"], getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [([f"[{i}]"], x) for i, x in enumerate(node)]
    return None


def _flatten(tree) -> Dict[str, Any]:
    """``{key path: leaf}`` in the JAX tree's leaf order."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        node = _pytree_form(node)
        if node is None:
            return                                  # an empty subtree
        kids = _children(node)
        if kids is None:
            out["/".join(prefix)] = node
            return
        for parts, child in kids:
            walk(child, prefix + parts)

    walk(tree, [])
    return out


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own dtype; bf16 as its uint16
    bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)     # a step counter
    return np.asarray(leaf)


def _write_shard_and_meta(outdir: str, tree: Any, step: int,
                          loader_state: Optional[Dict[str, Any]] = None,
                          metric: Optional[float] = None) -> None:
    """Write the shard archive and the meta.json sidecar.  The archive is
    ``np.savez``'s (an uncompressed zip of ``<key>.npy`` entries, in the
    JAX tree's leaf order), written one leaf at a time so the host holds
    a single leaf's copy, not the whole state's."""
    dtypes = {}
    with zipfile.ZipFile(os.path.join(outdir, SHARD), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, v in _flatten(tree).items():
            a = _to_numpy(v)
            dtypes[k] = (dtype_name(v.dtype) if isinstance(v, torch.Tensor)
                         else a.dtype.name)
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
            del a
    meta: Dict[str, Any] = {"step": step, "n_leaves": len(dtypes),
                            "format": 3, "dtypes": dtypes}
    if loader_state is not None:
        meta["loader_state"] = loader_state
    if metric is not None:
        meta["metric"] = float(metric)
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump(meta, f)


def _looks_like_checkpoint(path: str) -> bool:
    """Conservative guard before replacing an existing destination: only a
    previous checkpoint (committed or torn) or an empty dir may be
    clobbered — anything else is a user error we refuse to delete.
    Requires checkpoint-SPECIFIC evidence: a bare file named meta.json is
    not enough (datasets use that name too) — it must parse as our
    sidecar, or a shard archive / COMMIT marker must be present."""
    if not os.path.isdir(path):
        return False                           # a regular file is never ours
    entries = os.listdir(path)
    if not entries:
        return True
    if is_committed(path) or any(e.startswith("shard_") and e.endswith(".npz")
                                 for e in entries):
        return True
    meta_p = os.path.join(path, "meta.json")
    if os.path.exists(meta_p):
        try:
            with open(meta_p) as f:
                meta = json.load(f)
            return isinstance(meta, dict) and "n_leaves" in meta \
                and "step" in meta
        except Exception:
            return False
    return False


STEP_DIR_RE = re.compile(r"^step_\d+$")


def step_dir(base: str, step: int) -> str:
    """Canonical step-named checkpoint path under a base directory —
    what the retention policy prunes and ``latest``/``best`` point at."""
    return os.path.join(base, f"step_{step:08d}")


def _repoint_symlink(parent: str, name: str, target: str) -> None:
    """Atomically (re)point ``parent/name`` at sibling ``target``."""
    link = os.path.join(parent, name)
    tmp = os.path.join(parent, f".{name}.tmp-link")
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)


def _symlink_target(parent: str, name: str) -> Optional[str]:
    link = os.path.join(parent, name)
    if os.path.islink(link):
        return os.readlink(link)
    return None


def _metric_of(path: str) -> Optional[float]:
    meta_p = os.path.join(path, "meta.json")
    try:
        with open(meta_p) as f:
            m = json.load(f).get("metric")
        return float(m) if m is not None else None
    except Exception:
        return None


def _apply_retention(path: str, keep_last_n: Optional[int],
                     metric: Optional[float]) -> None:
    """Maintain ``latest``/``best`` symlinks beside ``path`` and prune
    old committed ``step_*`` siblings beyond ``keep_last_n``.  Pruning
    is deliberately narrow: only dirs NAMED like step checkpoints that
    also pass ``_looks_like_checkpoint`` are candidates, and a symlink
    target or the dir just written is never deleted."""
    parent = os.path.dirname(os.path.abspath(path))
    name = os.path.basename(path.rstrip(os.sep))
    _repoint_symlink(parent, "latest", name)
    if metric is not None:
        best = _symlink_target(parent, "best")
        best_metric = (_metric_of(os.path.join(parent, best))
                       if best is not None else None)
        # lower is better (loss-like); first metric-stamped save wins
        if best_metric is None or float(metric) <= best_metric:
            _repoint_symlink(parent, "best", name)
    if not keep_last_n or keep_last_n <= 0:
        return
    protected = {name}
    for link in ("latest", "best"):
        t = _symlink_target(parent, link)
        if t is not None:
            protected.add(t)
    sibs = [d for d in os.listdir(parent)
            if STEP_DIR_RE.match(d) and d not in protected
            and is_committed(os.path.join(parent, d))
            and _looks_like_checkpoint(os.path.join(parent, d))]
    # newest keep_last_n step dirs survive IN ADDITION to the protected
    # set; step number comes from the name (zero-padded, so lexical ==
    # numeric order)
    survivors = sorted(sibs)[-(keep_last_n - 1):] if keep_last_n > 1 else []
    for d in sibs:
        if d not in survivors:
            shutil.rmtree(os.path.join(parent, d), ignore_errors=True)


def resolve_checkpoint(path: str) -> str:
    """Resolve a ``--resume`` target: ``path`` itself when it is a
    checkpoint dir; otherwise follow a ``latest`` symlink inside it, or
    fall back to the newest committed ``step_*`` child.  Returns
    ``path`` unchanged when nothing matches (the loader then fails with
    its own, clearer error)."""
    if _looks_like_checkpoint(path) and os.listdir(path):
        return path
    if os.path.isdir(path):
        latest = _symlink_target(path, "latest")
        if latest is not None:
            cand = os.path.join(path, latest)
            if os.path.isdir(cand):
                return cand
        steps = sorted(d for d in os.listdir(path)
                       if STEP_DIR_RE.match(d)
                       and is_committed(os.path.join(path, d)))
        if steps:
            return os.path.join(path, steps[-1])
    return path


def load_loader_state(path: str) -> Optional[Dict[str, Any]]:
    """The ``loader_state`` entry saved with this checkpoint (format 3),
    or None for older checkpoints / runs without a streaming loader."""
    check_loadable(path)
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f).get("loader_state")


def save_checkpoint(path: str, tree: Any, step: int = 0, *,
                    loader_state: Optional[Any] = None,
                    keep_last_n: Optional[int] = None,
                    metric: Optional[float] = None) -> None:
    """Save ``tree`` atomically: shard + meta are staged in a temp dir,
    the ``COMMIT`` marker is written last, and the staged dir is renamed
    into place — a reader never observes a torn save at ``path``.

    ``loader_state`` (a dict or anything with ``.to_dict()``) rides
    ``meta.json``.  ``keep_last_n``/``metric`` turn on the retention
    policy: ``latest``/``best`` symlinks in the parent dir and pruning of
    older committed ``step_*`` siblings — meant for step-named paths
    from ``step_dir()``."""
    if loader_state is not None and hasattr(loader_state, "to_dict"):
        loader_state = loader_state.to_dict()
    path = path.rstrip(os.sep)
    # a previous save may have crashed mid-swap: restore its surviving
    # committed dir to `path` BEFORE the leftover cleanup below, so the
    # only committed copy on disk is never deleted
    _recover_interrupted_swap(path)
    # clobber guard BEFORE any work: never delete something that is not a
    # previous checkpoint (and never leak a staging dir on refusal)
    if os.path.exists(path) and not _looks_like_checkpoint(path):
        raise ValueError(
            f"refusing to overwrite {path!r}: it exists but does not "
            f"look like a checkpoint directory (no meta.json/"
            f"{COMMIT_MARKER}); choose an empty or fresh --ckpt path")
    staging = f"{path}.tmp-staging"
    backup = f"{path}.tmp-old"
    for leftover in (staging, backup):
        if os.path.exists(leftover):
            shutil.rmtree(leftover)
    os.makedirs(staging)
    _write_shard_and_meta(staging, tree, step, loader_state, metric)
    with open(os.path.join(staging, COMMIT_MARKER), "w") as f:
        f.write("committed\n")                 # marker iff dir is complete
    # swap: move the old checkpoint ASIDE (not rmtree) before installing
    # the staged one, so a crash at any point leaves either the old or
    # the new FULLY-COMMITTED dir on disk — never a half-written one at
    # `path`, and never a window with the only copy deleted
    if os.path.exists(path):
        os.rename(path, backup)
    os.replace(staging, path)                  # atomic on POSIX
    shutil.rmtree(backup, ignore_errors=True)
    if keep_last_n is not None or metric is not None:
        _apply_retention(path, keep_last_n, metric)


def _stored_tensor(a: np.ndarray, stored: Optional[str], want: torch.dtype,
                   key: str) -> torch.Tensor:
    """An archive array as a CPU tensor of its true dtype: the sidecar's
    "bfloat16" views the uint16 bits back; a raw void record (a
    pre-sidecar bf16 leaf) takes the template's dtype."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2 or want != torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key!r} has raw dtype {a.dtype} with no "
                f"dtype sidecar and does not match like dtype {want}")
        stored, a = BF16, a.view(np.uint16)
    a = np.asarray(a, order="C")           # keeps a 0-d array 0-d
    if stored == BF16 and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if stored is not None and a.dtype.name != stored:
        a = a.view(np.dtype(stored))
    return torch.from_numpy(a)


def _rebuild(like, prefix, data, dtypes, into: bool):
    """``like``'s structure with every leaf read from the archive: a
    tensor in the template's dtype on the template leaf's device or,
    with ``into``, copied into the template's own tensor; an int counter
    as an int.  Each leaf is read when it is reached."""
    from repro_torch.core.optim import FlatOptState, LambState, lamb_state_of
    if isinstance(like, FlatOptState):
        raise TypeError(
            "load_checkpoint: a resident FlatOptState template cannot be "
            "rebuilt from the archive (it holds the pytree form); load "
            "into to_pytree(state) and rebuild with from_pytree(opt, "
            "params), or pass into=True as the launcher's --resume does")
    if isinstance(like, LambState):
        return lamb_state_of(_rebuild(_pytree_form(like), prefix, data,
                                      dtypes, into))
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        key = "/".join(prefix)
        a = data[key]
        if isinstance(like, torch.Tensor):
            t = _stored_tensor(a, dtypes.get(key), like.dtype, key)
            if t.dtype != like.dtype:
                t = t.to(like.dtype)
            if into:
                if t.shape != like.shape:
                    raise ValueError(f"checkpoint leaf {key!r} has shape "
                                     f"{tuple(t.shape)}, the template "
                                     f"{tuple(like.shape)}")
                with torch.no_grad():
                    like.copy_(t)
                return like
            return t.to(like.device)
        return int(a)                               # a step counter
    vals = [_rebuild(child, prefix + parts, data, dtypes, into)
            for parts, child in kids]
    if isinstance(like, dict):
        order = sorted(like, key=lambda k: tuple(str(k).split(".")))
        by_key = dict(zip(order, vals))
        return {k: by_key[k] for k in like}
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def load_checkpoint(path: str, like: Any, *, into: bool = False):
    """Restore into the structure of ``like`` (a params dict, a state in
    its pytree form, or a dict of them; a ``LambState`` too).  Every
    restored leaf takes the DTYPE OF ``like`` — the sidecar recovers the
    stored bits exactly, then a cast (no-op when dtypes already agree)
    shields against checkpoints written at a different precision — and
    lands on the template leaf's device.  ``into=True``
    copies each leaf into the template's own tensor instead (shapes must
    agree), one leaf at a time, so the restore holds no second copy of
    the state on the device or the host.  Returns ``(tree, step)``.

    Raises ``ValueError`` for a torn save and ``KeyError`` when the
    archive lacks a leaf the template expects."""
    check_loadable(path)
    data = np.load(os.path.join(path, SHARD))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    missing = sorted(set(_flatten(like)) - set(data.files))
    if missing:
        raise KeyError(
            f"checkpoint at {path!r} lacks {len(missing)} leaves the "
            f"template expects (template/archive structure mismatch — "
            f"e.g. a different optimizer or chain layout than the one "
            f"saved): first missing {missing[:5]}")
    return _rebuild(like, [], data, dtypes, into), meta["step"]


def archive_keys(path: str):
    """The key set of a checkpoint's archive (the launcher reads the
    saved state form from it)."""
    return set(np.load(os.path.join(path, SHARD)).files)


def _host_copy(tree):
    """``tree`` (in its pytree form) with every tensor copied to host
    memory.  The copy is blocking, so it is complete when this returns:
    the next step may then rewrite the device buffers in place."""
    tree = _pytree_form(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    kids = _children(tree)
    if kids is None:
        return tree
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    vals = [_host_copy(child) for _, child in kids]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


class AsyncCheckpointer:
    """Non-blocking saves on top of the atomic ``save_checkpoint`` path.

    ``save()`` does the only step-coupled work SYNCHRONOUSLY — a blocking
    device→host copy of every leaf, after which the resident buffers are
    free for the next step to rewrite in place — and hands the host copy
    to a single background worker that runs the unchanged staged/atomic
    commit (including retention).  One worker thread means saves commit
    in submission order; a bounded queue applies back-pressure if
    commits fall behind the save cadence instead of accumulating host
    copies without limit.

    ``wait()`` blocks until every queued save has committed and
    re-raises the first background failure (also re-raised by the next
    ``save()`` — an async save error must not be silently swallowed).
    ``close()`` waits and stops the worker; the instance is also a
    context manager.  ``commit_delay_s`` artificially delays each commit
    — a test hook to prove training never blocks on commit I/O.
    """

    def __init__(self, max_pending: int = 2, commit_delay_s: float = 0.0):
        self.commit_delay_s = commit_delay_s
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, max_pending))
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-torch-async-ckpt")
        self._thread.start()

    def _worker(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                if self.commit_delay_s:
                    time.sleep(self.commit_delay_s)
                if self._error is None:   # fail fast after first error
                    path, tree, step, kw = job
                    save_checkpoint(path, tree, step, **kw)
            except BaseException as e:
                if self._error is None:
                    self._error = e
            finally:
                job = tree = None         # free the host copy now
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path: str, tree: Any, step: int = 0, *,
             loader_state: Optional[Any] = None,
             keep_last_n: Optional[int] = None,
             metric: Optional[float] = None) -> None:
        """Snapshot ``tree`` to host memory now; commit in background."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_pending()
        if loader_state is not None and hasattr(loader_state, "to_dict"):
            loader_state = loader_state.to_dict()
        host_tree = _host_copy(tree)
        self._q.put((path, host_tree, step,
                     {"loader_state": loader_state, "keep_last_n": keep_last_n,
                      "metric": metric}))

    def wait(self) -> None:
        """Block until all queued saves have committed; re-raise the
        first background failure."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the worker, and surface any pending error.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=30.0)
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *_) -> None:
        self.close()
