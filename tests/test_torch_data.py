"""``repro_torch.data`` against ``repro.data``, bitwise, on the CPU.

Held, for the same inputs:

  * ``SyntheticLM.read`` over several shards and offsets, at a small
    vocab and at gemma-2b's 256000 (``randint`` of shape ``()`` and the
    fold-in of an int32 example index, as the JAX package draws them);
  * ``synthetic_images`` and ``synthetic_images_source``;
  * packs: one written by either package is read by the other, a
    bfloat16 field included (its bits, without ``ml_dtypes`` on the port
    side), and ``dataset.json`` is the same bytes; the pack CLIs write
    the same index and arrays;
  * ``StreamingLoader`` over two epochs and more (a dropped epoch tail
    in every epoch): every batch and ``state.to_dict()`` after each, for
    1, 2 and 3 processes and each process index, over an in-memory
    source and a JAX-written pack;
  * ``seek`` and a resume from a ``LoaderState`` dict written by the
    other package, ``max_epochs``, ``batches_per_epoch``;
  * the errors either package raises, with the same messages.

The shard files themselves are not compared byte for byte: zip headers
carry timestamps.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data as J
import repro.data.pack as jpack
import repro_torch.data as T
import repro_torch.data.pack as tpack


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(v):
    """A field of either package as a numpy array of its bits' dtype:
    bfloat16 as uint16, so both sides compare without ml_dtypes."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _same(jb, tb):
    assert sorted(jb) == sorted(tb)
    for k in jb:
        a, b = _np(jb[k]), _np(tb[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _arrays(n, seq=6, seed=0):
    """Fields of every kind a pack holds: int32 tokens, an fp32 mask and
    a bfloat16 embedding (numpy through ml_dtypes for the JAX package)."""
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 1000, size=(n, seq)).astype(np.int32),
            "loss_mask": (rng.rand(n, seq) > 0.2).astype(np.float32),
            "emb": rng.randn(n, 3).astype(ml_dtypes.bfloat16)}


def _port_arrays(arrays):
    """The same fields as CPU tensors (bfloat16 from its bits)."""
    out = {}
    for k, v in arrays.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


# ------------------------------------------------------------- synthetic

@pytest.mark.parametrize("vocab,seq,shard,start,count", [
    (97, 16, 0, 0, 8), (97, 16, 3, 5, 3), (1024, 32, 2, 7, 1),
    (256000, 8, 0, 0, 2), (256000, 64, 3, 6, 2)])
def test_synthetic_read_is_the_jax_read(vocab, seq, shard, start, count):
    j = J.SyntheticLM(vocab, seq, 1, seed=7, epoch_examples=32, n_shards=4)
    t = T.SyntheticLM(vocab, seq, 1, seed=7, epoch_examples=32, n_shards=4)
    assert t.shard_lengths() == j.shard_lengths() == (8,) * 4
    assert t.optimal_loss() == j.optimal_loss()
    _same(j.read(shard, start, count), t.read(shard, start, count))


@pytest.mark.parametrize("n,seed,kw", [(12, 0, {}), (7, 3, {"n_classes": 4}),
                                       (5, 1, {"image_size": 16, "noise": 3.0})])
def test_synthetic_images_are_the_jax_images(n, seed, kw):
    jx, jy = J.synthetic_images(n, seed=seed, **kw)
    tx, ty = T.synthetic_images(n, seed=seed, **kw)
    _same({"x": jx, "y": jy}, {"x": tx, "y": ty})
    js = J.synthetic_images_source(n, seed=seed, shard_size=4, **kw)
    ts = T.synthetic_images_source(n, seed=seed, shard_size=4, **kw)
    assert ts.shard_lengths() == js.shard_lengths()
    _same(js.read(0, 1, 2), ts.read(0, 1, 2))


# ---------------------------------------------------------------- format

def _pack(pkg, path, arrays):
    return pkg.pack_dataset(str(path), arrays, shard_size=16,
                            meta={"kind": "test", "vocab_size": 1000})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_pack_reads_in_the_other_package(writer, tmp_path):
    """40 examples in shards of 16, 16, 8; the index the same bytes; every
    read of either reader the same bits, bf16 included."""
    arrays = _arrays(40)
    _pack(J, tmp_path / "j", arrays)
    _pack(T, tmp_path / "t", _port_arrays(arrays))
    assert (open(tmp_path / "j" / "dataset.json", "rb").read()
            == open(tmp_path / "t" / "dataset.json", "rb").read())
    path = str(tmp_path / ("j" if writer == "jax" else "t"))
    js, ts = J.DiskShardedSource(path), T.DiskShardedSource(path)
    assert ts.shard_lengths() == js.shard_lengths() == (16, 16, 8)
    assert ts.fields == js.fields and ts.meta == js.meta
    assert T.n_examples(ts) == 40
    for shard, start, count in ((0, 0, 16), (1, 4, 10), (2, 7, 1), (2, 0, 0)):
        got = ts.read(shard, start, count)
        assert got["emb"].dtype == torch.bfloat16
        _same(js.read(shard, start, count), got)
    ts.close()
    js.close()


def test_streaming_writer_flushes_the_jax_shards(tmp_path):
    """Batches of uneven size through ``DataPackWriter`` / ``pack_iterable``:
    the same shard boundaries and index as the JAX writer."""
    arrays = _arrays(29)
    cuts = [0, 3, 11, 12, 29]

    def batches(conv):
        return [conv({k: v[a:b] for k, v in arrays.items()})
                for a, b in zip(cuts, cuts[1:])]
    J.pack_iterable(str(tmp_path / "j"), batches(dict), shard_size=5)
    T.pack_iterable(str(tmp_path / "t"), batches(_port_arrays), shard_size=5)
    assert (open(tmp_path / "j" / "dataset.json", "rb").read()
            == open(tmp_path / "t" / "dataset.json", "rb").read())
    js = J.DiskShardedSource(str(tmp_path / "j"))
    ts = T.DiskShardedSource(str(tmp_path / "t"))
    assert ts.shard_lengths() == (5,) * 5 + (4,)
    for s, n in enumerate(ts.shard_lengths()):
        _same(js.read(s, 0, n), ts.read(s, 0, n))


@pytest.mark.parametrize("flags", [
    ["--synthetic-lm", "--vocab", "256000", "--seq", "8", "--n", "10",
     "--shard-size", "4", "--seed", "2"],
    ["--synthetic-images", "--n", "6", "--shard-size", "4", "--seed", "1"],
    ["--from-npz"]])
def test_pack_cli_writes_the_jax_pack(flags, tmp_path, capsys):
    if flags == ["--from-npz"]:
        npz = str(tmp_path / "in.npz")
        a = _arrays(9)
        np.savez(npz, tokens=a["tokens"], loss_mask=a["loss_mask"])
        flags = flags + [npz, "--shard-size", "4"]
    assert jpack.main([str(tmp_path / "j")] + flags) == 0
    jout = capsys.readouterr().out
    assert tpack.main([str(tmp_path / "t")] + flags) == 0
    tout = capsys.readouterr().out
    assert tout.replace(str(tmp_path / "t"), "OUT") == \
        jout.replace(str(tmp_path / "j"), "OUT")
    assert (open(tmp_path / "j" / "dataset.json", "rb").read()
            == open(tmp_path / "t" / "dataset.json", "rb").read())
    js = J.DiskShardedSource(str(tmp_path / "j"))
    ts = T.DiskShardedSource(str(tmp_path / "t"))
    for s, n in enumerate(ts.shard_lengths()):
        _same(js.read(s, 0, n), ts.read(s, 0, n))


# ---------------------------------------------------------------- loader

def _loaders(src_j, src_t, batch, **kw):
    return (J.StreamingLoader(src_j, batch, **kw),
            T.StreamingLoader(src_t, batch, **kw))


def _walk(jl, tl, n):
    """n batches of each loader: the same bits and the same state after
    each (the state before the first too)."""
    assert tl.state.to_dict() == jl.state.to_dict()
    for _ in range(n):
        _same(next(jl), next(tl))
        assert tl.state.to_dict() == jl.state.to_dict()


# 7 shards of 5, 5, 5, 5, 5, 5, 3: every process owns at least two, and
# the local batch leaves a tail to drop in every epoch
@pytest.mark.parametrize("P,p", [(1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2)])
def test_loader_batches_and_states_are_the_jax_loaders(P, p):
    arrays = _arrays(33)
    jl, tl = _loaders(J.MemorySource(arrays, shard_size=5),
                      T.MemorySource(_port_arrays(arrays), shard_size=5),
                      3 * P, seed=11, process_index=p, process_count=P)
    assert tl.local_batch == jl.local_batch == 3
    assert tl.batches_per_epoch() == jl.batches_per_epoch()
    _walk(jl, tl, 2 * tl.batches_per_epoch() + 2)   # into a third epoch
    assert tl.state.epoch == 2


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_over_a_jax_pack_is_the_jax_loader(shuffle, tmp_path):
    path = str(tmp_path / "ds")
    _pack(J, path, _arrays(40))
    jl, tl = _loaders(J.DiskShardedSource(path), T.DiskShardedSource(path),
                      6, seed=4, shuffle=shuffle)
    _walk(jl, tl, 14)                  # 6 batches an epoch: two and a bit


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_loader_key_is_the_jax_key(seed):
    arrays = _arrays(8)
    jl, tl = _loaders(J.MemorySource(arrays), T.MemorySource(_port_arrays(arrays)),
                      4, seed=seed)
    assert tl.state.key == jl.state.key


def test_seek_and_resume_from_the_other_packages_state():
    """Cursors taken from one package's loader, through JSON, seek the
    other's: the rest of the stream is the same bits, across an epoch."""
    arrays = _arrays(33)
    jsrc, tsrc = J.MemorySource(arrays, shard_size=5), \
        T.MemorySource(_port_arrays(arrays), shard_size=5)
    jl, tl = _loaders(jsrc, tsrc, 4, seed=3)
    states, batches = [], []
    for _ in range(12):                # 8 batches an epoch
        states.append(json.dumps(jl.state.to_dict()))
        batches.append(next(jl))
    for k in (0, 3, 7, 8, 11):
        st = T.LoaderState.from_dict(json.loads(states[k]))
        resumed = T.StreamingLoader(tsrc, 4, seed=99, state=st)
        seeked = T.StreamingLoader(tsrc, 4, seed=99)
        seeked.seek(st)
        for want in batches[k:]:
            _same(want, next(resumed))
            _same(want, next(seeked))
    # and the JAX loader resumes from a port cursor
    for _ in range(5):
        next(tl)
    jr = J.StreamingLoader(jsrc, 4, state=J.LoaderState.from_dict(
        json.loads(json.dumps(tl.state.to_dict()))))
    _walk(jr, tl, 6)


def test_epoch_tail_dropped_and_max_epochs():
    arrays = _arrays(10)
    jl, tl = _loaders(J.MemorySource(arrays, shard_size=5),
                      T.MemorySource(_port_arrays(arrays), shard_size=5),
                      4, shuffle=False, max_epochs=2)
    assert tl.batches_per_epoch() == 2
    _walk(jl, tl, 4)                   # 2 full batches an epoch, tails dropped
    assert all(v.shape[0] == 4 for v in tl.source.read(0, 0, 4).values())
    for it in (jl, tl):
        with pytest.raises(StopIteration):
            next(it)
    assert tl.state.to_dict() == jl.state.to_dict()


def test_state_round_trips_and_is_checked():
    st = T.LoaderState(epoch=2, shard_cursor=5, offset=3, key=(7, 9))
    assert T.LoaderState.from_dict(json.loads(json.dumps(st.to_dict()))) == st
    assert st.to_dict() == J.LoaderState(2, 5, 3, (7, 9)).to_dict()
    with pytest.raises(ValueError, match=r"missing fields \['key', 'offset', "
                                         r"'shard_cursor'\]"):
        T.LoaderState.from_dict({"epoch": 0})


def test_sources_satisfy_the_protocol(tmp_path):
    _pack(T, tmp_path / "ds", _port_arrays(_arrays(4)))
    for src in (T.MemorySource(_port_arrays(_arrays(4))),
                T.SyntheticLM(16, 4, 1, epoch_examples=4, n_shards=2),
                T.DiskShardedSource(str(tmp_path / "ds"))):
        assert isinstance(src, T.DataSource)
    assert not isinstance(object(), T.DataSource)


# ---------------------------------------------------------------- errors

def _mem(pkg, n=16, **kw):
    arrays = _arrays(n)
    return pkg.MemorySource(arrays if pkg is J else _port_arrays(arrays), **kw)


def _index_removed(pkg, d):
    pkg.pack_dataset(d, {"a": np.zeros((4, 2), np.int32)}, shard_size=4)
    os.remove(os.path.join(d, "dataset.json"))
    pkg.DiskShardedSource(d)


def _pack_twice(pkg, d):
    pkg.pack_dataset(d, {"a": np.zeros((4, 2), np.int32)}, shard_size=4)
    pkg.DataPackWriter(d, shard_size=4)


def _unknown_format(pkg, d):
    os.makedirs(d)
    with open(os.path.join(d, "dataset.json"), "w") as f:
        json.dump({"format": 2}, f)
    pkg.DiskShardedSource(d)


def _schema_change(pkg, d):
    w = pkg.DataPackWriter(d)
    w.add({"a": np.zeros((2, 3), np.int32)})
    w.add({"a": np.zeros((2, 4), np.int32)})


# each call(pkg, a fresh dir) must raise the same type and message in
# both packages (the dir's name aside)
ERROR_CASES = {
    "batch_not_divisible": lambda pkg, d: pkg.StreamingLoader(
        _mem(pkg), 5, process_index=0, process_count=2),
    "epoch_below_batch": lambda pkg, d: pkg.StreamingLoader(
        _mem(pkg, 4, shard_size=4), 8, process_index=0, process_count=1),
    "process_out_of_range": lambda pkg, d: pkg.StreamingLoader(
        _mem(pkg), 4, process_index=2, process_count=2),
    "owns_no_shard": lambda pkg, d: pkg.StreamingLoader(
        _mem(pkg, 4), 4, process_index=1, process_count=2),
    "read_past_shard": lambda pkg, d: _mem(pkg, shard_size=5).read(3, 0, 2),
    "read_bad_shard": lambda pkg, d: _mem(pkg, shard_size=5).read(4, 0, 1),
    "fields_disagree": lambda pkg, d: pkg.MemorySource(
        {"a": np.zeros(3), "b": np.zeros(4)}),
    "no_example": lambda pkg, d: pkg.MemorySource({"a": np.zeros((0, 2))}),
    "synthetic_shards": lambda pkg, d: pkg.SyntheticLM(
        8, 4, 1, epoch_examples=10, n_shards=4),
    "synthetic_read_range": lambda pkg, d: pkg.SyntheticLM(
        8, 4, 1, epoch_examples=8, n_shards=2).read(1, 3, 2),
    "index_is_the_commit_marker": _index_removed,
    "pack_refuses_an_existing_dataset": _pack_twice,
    "unknown_format": _unknown_format,
    "nothing_packed": lambda pkg, d: pkg.DataPackWriter(d).close(),
    "writer_fields_disagree": lambda pkg, d: pkg.DataPackWriter(d).add(
        {"a": np.zeros((2, 3), np.int32), "b": np.zeros((1, 3))}),
    "writer_schema_change": _schema_change,
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_match_the_jax_package(case, tmp_path):
    got = {}
    for name, pkg in (("jax", J), ("port", T)):
        d = str(tmp_path / name)
        with pytest.raises(Exception) as e:
            ERROR_CASES[case](pkg, d)
        got[name] = (type(e.value), str(e.value).replace(d, "DIR"))
    assert got["port"] == got["jax"]
