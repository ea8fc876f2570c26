"""How a real distributed encode splits a hierarchy's events across levels:
how many of a block's top-level events keep a raw top-level atom (the rest
are singletons, stored one level down), whose count of blocks the
restore-levels cell's writer draws from
(`configs/hier-flagship-dist.json`'s ``writer.blocks_by_raw_events``).

    python benchmark/measure_singletons.py --config hier-flagship --seeds 1,2 [--blocks 256]

Per seed, the ingest cells' signal pool (`inputs.signal_pool`, the first
``--blocks`` blocks) of the configuration is encoded by
``CorpusEncoder(distributed=True)`` on the card, and the container is
parsed by the reference's frozen reader.  One JSON line a seed, and one
last over all seeds: events a level, the singleton share, the share of
blocks holding more than one level, the spread of the blocks' shares, and
the count of blocks holding r events at the top level, r = 0, 1, ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hscbench import inputs  # noqa: E402
from reference import container  # noqa: E402


def split(cfg, blob: bytes) -> np.ndarray:
    """``[blocks, levels]`` events a level of each block of `blob`."""
    offsets = container.read_index(blob)
    out = np.zeros((len(offsets) - 1, cfg.num_levels), np.int64)
    for b in range(len(offsets) - 1):
        for s in container.read_block(cfg, blob, int(offsets[b]))[0]:
            out[b, s.level] += len(s.positions)
    return out


def summary(counts: np.ndarray) -> dict:
    total = counts.sum(1)
    below = total - counts[:, -1]
    shares = below / np.maximum(total, 1)
    return {
        "blocks": int(counts.shape[0]),
        "events_a_level": counts.sum(0).tolist(),
        "top_events_a_block_mean": float(total.mean()),
        "singleton_share": float(below.sum() / max(total.sum(), 1)),
        "blocks_with_several_levels": float(np.mean((counts > 0).sum(1) > 1)),
        "block_share_p10_p50_p90": [float(v) for v in np.percentile(shares, [10, 50, 90])],
        "blocks_by_raw_events": np.bincount(counts[:, -1]).tolist(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="hier-flagship")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from hsc_torch.params import dictionary_from_arrays
    from hsc_torch.runtime import CorpusEncoder

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", f"{args.config}.json")) as f:
        config = json.load(f)
    device = torch.device(args.device)
    every = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cfg = inputs.codec_config(config)
        mld = inputs.make_dictionary(config, seed)
        pool = inputs.signal_pool(mld, args.blocks, config["signals"], seed, device)
        enc = CorpusEncoder(dictionary_from_arrays(cfg.to_json(), mld.dicts), device=device,
                            batch_size=int(config["batch_size"]), distributed=True)
        counts = split(cfg, enc.encode(pool, index=True))
        every.append(counts)
        print(json.dumps({"seed": seed, **summary(counts)}), flush=True)
    print(json.dumps({"config": args.config, "seeds": args.seeds, **summary(np.concatenate(every))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
