"""Weak-scaling harness for the PyTorch / CUDA port's data-parallel codec,
the counterpart of `scripts/bench_scaling.py`.

Measures blocks/s at 1, 2, 4, ... shards (up to `--max-shards`) with a
constant per-shard load and reports the parallel efficiency, for the
single-level encode (`parallel.DataParallelEncoder`), the 2-level
hierarchical encode (`--hierarchical`, `parallel.HierarchicalDataParallelEncoder`)
or the sharded decode (`--decode`, `parallel.dp.DataParallelDecoder`; the
rows are summed on the device and the call ends with a synchronize, so the
copy of the rows to the host stays out).  Each row also times the UNSHARDED
local path at the same load in turns with the sharded one:
`vs_unsharded_local` is local time over sharded time, the mesh's own cost
where the shards share their hardware.

The mesh (`parallel.make_mesh`) takes the visible cards in turn, shard i on
card i mod n.  On a host with one card every shard is `cuda:0` (as
chip_smoke.py phase 14 builds its meshes), so the shards run one after
another on one device: this then measures the mesh's overhead, not scaling,
and the summary says so with `"shards_share_one_device": true`.  On
`--device cpu` every shard is the CPU, and the same holds.

Config: `--counts` atoms of width `--scales` (level 1 of `--hierarchical`:
half the atoms, three times the width), `--num-coefs` coefficients,
`--block-size` samples; dictionary seed 7, signals seed 3,
`SignalGenerator(rates=2e-3)`.  Best of 3 after one warm call.  `--device`
replaces `--platform`: 'cuda' (default; exits if no card is visible),
'cuda:N' or 'cpu'.  One JSON line per shard count, then the summary line.

  python scripts/torch_bench_scaling.py                     # every visible card
  python scripts/torch_bench_scaling.py --blocks-per-shard 4 --max-shards 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hsc_torch.cli import _device  # noqa: E402
from hsc_torch.device import device_name, synchronize  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--blocks-per-shard", type=int, default=2)
    p.add_argument("--max-shards", type=int, default=8)
    p.add_argument("--block-size", type=int, default=4096)
    p.add_argument("--num-coefs", type=int, default=128)
    p.add_argument("--counts", type=int, default=32)
    p.add_argument("--scales", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; exits if no card is visible), 'cuda:N' or 'cpu'")
    p.add_argument("--hierarchical", action="store_true",
                   help="weak-scale the 2-level hierarchical DP pipeline instead of single-level")
    p.add_argument("--decode", action="store_true",
                   help="weak-scale the mesh-sharded DECODE (parallel.dp.DataParallelDecoder) instead of encode")
    return p.parse_args(argv)


def measure(*, counts: int, scales: int, num_coefs: int, block_size: int, blocks_per_shard: int,
            max_shards: int, hierarchical: bool, decode: bool, device) -> dict:
    """One result row per shard count (each printed as it comes) -> the
    summary dict."""
    import torch

    from hsc_torch import CodecConfig, MultilevelDictionary, SignalGenerator
    from hsc_torch.models import ConvolutionalSparseCoder, HierarchicalConvolutionalSparseCoder
    from hsc_torch.models.coder import to_host
    from hsc_torch.parallel import DataParallelEncoder, HierarchicalDataParallelEncoder, make_mesh
    from hsc_torch.parallel.dp import DataParallelDecoder
    from hsc_torch.utils import Timer

    dev = torch.device(device)
    if hierarchical:
        cfg = CodecConfig(
            counts=(counts, max(counts // 2, 2)), scales=(scales, 3 * scales),
            num_coefs=(num_coefs, max(num_coefs // 2, 2)), block_size=block_size,
        )
    else:
        cfg = CodecConfig(counts=(counts,), scales=(scales,), num_coefs=(num_coefs,), block_size=block_size)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    gen = SignalGenerator(mld, rates=2e-3)

    shard_counts = [s for s in (1, 2, 4, 8, 16, 32) if s <= max_shards]
    if dev.type == "cuda":
        first = dev.index or 0
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{(first + i) % n_cards}" for i in range(max(shard_counts))]
    else:
        devices = ["cpu"] * max(shard_counts)
    results = []
    base_rate = None
    hcoder = HierarchicalConvolutionalSparseCoder(mld, device=dev)
    if decode:
        nb_max = max(shard_counts) * blocks_per_shard
        xs_all = gen.generate_signals(nb_max, cfg.block_size, seed=3)
        top = cfg.num_levels - 1
        streams_all = [b[top] for b in hcoder.encode_batch(xs_all)]
    for s in shard_counts:
        mesh = make_mesh({"data": s}, devices=devices[:s])
        nb = s * blocks_per_shard
        if decode:
            dpd = DataParallelDecoder(mesh, hcoder)
            streams = streams_all[:nb]

            def run():
                dpd.decode_batch_device(streams).sum()
                synchronize(dev)

            def local():
                hcoder.reconstruct_batch_device(streams).sum()
                synchronize(dev)
        elif hierarchical:
            hdp = HierarchicalDataParallelEncoder(mesh, hcoder)
            xs = gen.generate_signals(nb, cfg.block_size, seed=3)

            def run():
                hdp.encode(xs)

            def local():
                hcoder.encode_batch(xs)
        else:
            coder = ConvolutionalSparseCoder(mld, device=dev)
            dp = DataParallelEncoder(mesh, coder.mp)
            xs = gen.generate_signals(nb, cfg.block_size, seed=3)

            def run():
                dp.encode(xs)

            def local():
                # to the host, as dp.encode gathers there
                to_host(coder.mp.compute_coefficients_batch(xs))
        for fn in (run, local):
            fn()  # warm
        best = best_local = float("inf")
        for _ in range(3):
            with Timer() as t:
                run()
            best = min(best, t.elapsed)
            with Timer() as t:
                local()
            best_local = min(best_local, t.elapsed)
        rate = nb / best
        if base_rate is None:
            base_rate = rate
        results.append({"shards": s, "blocks": nb, "blocks_per_s": rate,
                        "weak_scaling_efficiency": rate / (base_rate * s),
                        "vs_unsharded_local": best_local / best})
        print(json.dumps(results[-1]), flush=True)
    used = devices[: max(shard_counts)]
    return {"summary": results, "shards_share_one_device": len(set(used)) < len(used),
            "device": device_name(dev)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = _device(args)  # as the port's CLI resolves it: no CPU fallback
    out = measure(counts=args.counts, scales=args.scales, num_coefs=args.num_coefs, block_size=args.block_size,
                  blocks_per_shard=args.blocks_per_shard, max_shards=args.max_shards,
                  hierarchical=args.hierarchical, decode=args.decode, device=dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
