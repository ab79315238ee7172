"""``repro-data-pack`` CLI — write a sharded on-disk dataset.  A port of
``repro.data.pack`` with its flags and messages; either package reads
the packs the other writes.

    # pack an existing .npz/.npy of arrays (fields keep their names)
    python -m repro_torch.data.pack OUT --from-npz corpus.npz --shard-size 1024

    # materialize the synthetic bigram LM as a real on-disk dataset
    python -m repro_torch.data.pack OUT --synthetic-lm --vocab 512 --seq 128 \\
        --n 8192 --shard-size 1024

    # materialize the Table-2 image proxy
    python -m repro_torch.data.pack OUT --synthetic-images --n 4096

The output directory is a ``data.format`` pack: ``shard_*.npz`` files
plus a ``dataset.json`` index written last (the commit marker).  For
the synthetic LM the index ``meta`` records vocab/seq/branching/seed so
consumers (``repro_torch.launch.train --data-dir``) can validate
compatibility instead of guessing.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np


def _pack_lm(out: str, vocab: int, seq: int, n: int, shard_size: int,
             seed: int, branching: int) -> str:
    from repro_torch.data.format import DataPackWriter
    from repro_torch.data.synthetic import SyntheticLM
    src = SyntheticLM(vocab, seq, batch_size=1, seed=seed,
                      branching=branching, epoch_examples=n,
                      n_shards=max(1, n // shard_size) or 1)
    meta = {"kind": "synthetic_lm", "vocab_size": vocab, "seq_len": seq,
            "branching": branching, "seed": seed,
            "optimal_loss": src.optimal_loss()}
    with DataPackWriter(out, shard_size=shard_size, meta=meta) as w:
        step = min(shard_size, 2048)
        done = 0
        for s, length in enumerate(src.shard_lengths()):
            off = 0
            while off < length:
                take = min(step, length - off)
                w.add(src.read(s, off, take))
                off += take
                done += take
    print(f"[pack] {done} synthetic-LM examples -> {out}")
    return out


def _pack_images(out: str, n: int, shard_size: int, seed: int) -> str:
    from repro_torch.data.format import pack_dataset
    from repro_torch.data.synthetic import synthetic_images
    x, y = synthetic_images(n, seed=seed)
    pack_dataset(out, {"x": x, "y": y}, shard_size=shard_size,
                 meta={"kind": "synthetic_images", "seed": seed})
    print(f"[pack] {n} synthetic images -> {out}")
    return out


def _pack_npz(out: str, path: str, shard_size: int) -> str:
    from repro_torch.data.format import pack_dataset
    data = np.load(path)
    arrays = ({k: data[k] for k in data.files} if hasattr(data, "files")
              else {"data": data})
    pack_dataset(out, arrays, shard_size=shard_size,
                 meta={"kind": "npz", "source": path})
    n = next(iter(arrays.values())).shape[0]
    print(f"[pack] {n} examples from {path} -> {out}")
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro-data-pack")
    ap.add_argument("out", help="output dataset directory")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-npz", metavar="FILE",
                     help="pack the arrays of an .npz/.npy file")
    src.add_argument("--synthetic-lm", action="store_true",
                     help="materialize the synthetic bigram LM on disk")
    src.add_argument("--synthetic-images", action="store_true",
                     help="materialize the Table-2 image proxy on disk")
    ap.add_argument("--n", type=int, default=8192,
                    help="examples to generate (synthetic sources)")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--branching", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-size", type=int, default=1024,
                    help="examples per shard — also the shuffle "
                         "granularity of the streaming loader")
    args = ap.parse_args(argv)

    if args.from_npz:
        _pack_npz(args.out, args.from_npz, args.shard_size)
    elif args.synthetic_lm:
        n = (args.n // args.shard_size) * args.shard_size or args.shard_size
        if n != args.n:
            print(f"[pack] rounding --n {args.n} -> {n} "
                  f"(whole shards of {args.shard_size})")
        _pack_lm(args.out, args.vocab, args.seq, n, args.shard_size,
                 args.seed, args.branching)
    else:
        _pack_images(args.out, args.n, args.shard_size, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
