"""Weights across the two packages, and the port's import boundary.

``repro_torch.convert`` carries the JAX package's params pytree (as
numpy arrays) into the port's ``{dotted.path: Tensor}`` and back,
bitwise.  The port imports ``torch``, never ``jax``, and nothing of
``repro``; ``chip_smoke.py`` neither."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg
from repro.models import model_defs as jax_model_defs
from repro.models.param import materialize as jax_materialize
from repro_torch.convert import from_numpy_tree, to_numpy_tree

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_trees_bitwise(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


@pytest.mark.parametrize("arch,param_dtype", [("gemma-2b", "float32"),
                                              ("gemma2-27b", "float32"),
                                              ("gemma-2b", "bfloat16")])
def test_jax_params_round_trip_bitwise(arch, param_dtype):
    cfg = dataclasses.replace(jcfg.smoke_variant(jcfg.ARCHS[arch]),
                              param_dtype=param_dtype)
    params = jax.tree.map(np.asarray, jax_materialize(jax_model_defs(cfg),
                                                      jax.random.PRNGKey(0)))
    flat = from_numpy_tree(params)
    assert "blocks.L0.attn.wq" in flat and "final_norm.scale" in flat
    n_periods = jcfg.layer_pattern(cfg)[2]
    assert flat["blocks.L0.attn.wq"].shape[0] == n_periods     # stacked dim leads
    assert flat["embed"].dtype == getattr(torch, param_dtype)
    _assert_trees_bitwise(params, to_numpy_tree(flat))


def test_special_values_and_mixed_dtypes_round_trip_bitwise():
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 3.4e38],
                       np.float32)
    tree = {"a": {"f32": special, "i32": np.arange(-3, 3, dtype=np.int32)},
            "b": np.asarray(jnp.asarray(special, jnp.bfloat16)),
            "c": np.ones((2, 0, 3), np.float32)}
    back = to_numpy_tree(from_numpy_tree(tree))
    _assert_trees_bitwise(tree, back)
    assert back["b"].dtype == jnp.bfloat16


def test_tensors_carry_the_same_values():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    t = from_numpy_tree({"w": x, "h": np.asarray(jnp.asarray(x, jnp.bfloat16))})
    assert torch.equal(t["w"], torch.from_numpy(x))
    assert torch.equal(t["h"], torch.from_numpy(x).to(torch.bfloat16))


def test_keys_with_the_separator_are_refused():
    with pytest.raises(ValueError):
        from_numpy_tree({"a.b": np.zeros(1, np.float32)})


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.data, repro_torch.data.pack, "
            "repro_torch.models.convnet, repro_torch.tracker.counters, "
            "repro_torch.training.loops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
