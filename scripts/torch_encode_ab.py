#!/usr/bin/env python3
"""Time the init's energy e0 and the corpus encodes of one tree of the port
on an NVIDIA card, for comparing two trees in one chip call.

    python3 scripts/torch_encode_ab.py [--root DIR] [--label NAME]

`--root` is the tree whose `hsc_torch` is imported (default: this
repository); run a parent tree unpacked from `git archive` and this one in
turns (P C C P) in one call.  For the flat flagship (dictionary seed 7,
signals seed 3) and the flagship hierarchy of `bench.py:257-262`
(dictionary seed 9, signals seed 5) under `hier_init` 'int8' and 'f32',
128 blocks each, `CorpusEncoder(device="cuda")` at its default batch of 64,
it prints:

  - the encode rate (host wall, MB/s of float32 input, 5 encodes);
  - the device memory peak of one encode (`torch.cuda.max_memory_allocated`
    past what was allocated before it);
  - the container's SHA-256, which must be the same on both trees;
  - per 64-block batch, with CUDA events over 20 back-to-back calls (4
    rounds): the f32 init the tree runs (`ops.encode.encode_init_batched`)
    and its e0 alone (`ops.encode.block_energy` where the tree has it, else
    the float32 `sum` of the squares that it replaces), on the level-0
    blocks ``[64, 16384, 1]`` and, for the f32 hierarchy, on the level-1
    map ``[64, 16353, 64]`` that the level-0 events hand on.

Each line is tagged with `--label`; the last line is one JSON object with
these numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS, BATCH = 128, 64


def _smoke():
    """This repository's chip_smoke.py (its configs and timing helpers),
    whatever tree `hsc_torch` comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="tree whose hsc_torch is imported")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_encode_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import hsc_torch
    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.ops import encode as ops_encode
    from hsc_torch.runtime import CorpusEncoder

    smoke = _smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    tag = f"[{args.label}]"
    print(f"{tag} hsc_torch from {os.path.dirname(hsc_torch.__file__)}; card {smi}", flush=True)
    dev = torch.device("cuda")
    route = "block_energy" if hasattr(ops_encode, "block_energy") else "sum"
    if route == "block_energy":
        energy = ops_encode.block_energy
    else:
        def energy(x):
            return x.square().sum(dim=(1, 2))

    def rounds_ms(fn):
        fn()
        return [smoke.cuda_ms(fn, 20) for _ in range(4)]

    out = {"tree": args.label, "card": smi, "e0_route": route}
    cells = [("flat", smoke.FLAGSHIP, 7, 3), ("hier_int8", smoke.HIER, 9, 5),
             ("hier_f32", dict(smoke.HIER, hier_init="f32"), 9, 5)]
    for name, kw, dseed, sseed in cells:
        cfg = make_test_config(**kw)
        mld = MultilevelDictionary.generate(cfg, seed=dseed)
        xs = SignalGenerator(mld, rates=2e-3).generate_signals(N_BLOCKS, cfg.block_size, seed=sseed)
        codec = CorpusEncoder(mld, device=dev)
        blob = codec.encode(xs)  # warm: the kernels are built and every shape seen
        mb = N_BLOCKS * cfg.block_size * 4 / 1e6
        rate = [mb / smoke.wall_s(lambda: codec.encode(xs)) for _ in range(5)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        codec.encode(xs)
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        cell = dict(encode_mb_s=rate, peak_mib=peak_mib, sha256=hashlib.sha256(blob).hexdigest(),
                    container_bytes=len(blob))
        coder = codec.coder
        x0 = torch.from_numpy(xs[:BATCH, :, None]).to(dev)
        maps = [("level0", x0, coder.coders[0].mp.bank)]
        if name == "hier_f32":
            enc0 = coder.coders[0].mp.compute_coefficients_batch(x0)
            maps.append(("level1", coder.handoff(0, enc0), coder.coders[1].mp.bank))
        if name != "hier_int8":  # its level 0 is the flat cell's problem
            for lv, x, bank in maps:
                cell[f"{lv}_shape"] = list(x.shape)
                cell[f"{lv}_init_ms"] = rounds_ms(lambda: ops_encode.encode_init_batched(x, bank))
                cell[f"{lv}_e0_ms"] = rounds_ms(lambda: energy(x))
        out[name] = cell
        print(f"{tag} {name}: encode {smoke.stats(rate, 'MB/s', '.2f')}; memory peak {peak_mib:.1f} MiB; "
              f"container {len(blob)} bytes sha256 {cell['sha256'][:16]}", flush=True)
        for lv, x, _ in maps if name != "hier_int8" else []:
            print(f"{tag} {name} {lv} {tuple(x.shape)}: init {smoke.stats(cell[f'{lv}_init_ms'], 'ms')}, "
                  f"e0 ({out['e0_route']}) {smoke.stats(cell[f'{lv}_e0_ms'], 'ms')}", flush=True)
        del codec, coder, maps, x0
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"torch_encode_ab: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
