"""Command-line codec of the PyTorch / CUDA port: encode/decode/inspect HSCT
streams (`hsc-torch-codec`), the counterpart of `hsc_tpu.cli`.

The compressed stream carries the full codec config (docs/FORMAT.md); the
dictionary (learned atom waveforms) is codec state and travels as a .npz file
(`MultilevelDictionary.save`).  Containers, decoded rows and dictionaries
are the JAX package's formats, so either CLI reads what the other wrote.

  # encode a 1-D float32 signal (.npy), reshaped into config-sized blocks
  python -m hsc_torch.cli encode --dict d.npz --input x.npy --output x.hsct

  # decode back to .npy
  python -m hsc_torch.cli decode --dict d.npz --input x.hsct --output y.npy

  # stream info + exact rate accounting
  python -m hsc_torch.cli info --input x.hsct

  # learn a dictionary from a corpus (the reference's multilevel training
  # driver, SURVEY.md §3.5, as a CLI verb)
  python -m hsc_torch.cli learn --input corpus.npy --output d.npz \\
      --counts 32,16 --scales 32,96 --learn-coefs 256,128

  # assemble a container from per-process encode journals (multi-host
  # process-0 assembly, SURVEY.md §2.3 P9; the journal dir is
  # self-describing — no --dict needed)
  python -m hsc_torch.cli assemble --input journal_dir/ --output x.hsct

encode, decode and learn run on `--device` (default 'cuda'); on a host
without a card they exit with an error unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "command", choices=["encode", "decode", "info", "learn", "assemble"]
    )
    p.add_argument("--input", required=True,
                   help="signal .npy/.wav (encode/learn), container .hsct "
                   "(decode/info), or journal DIRECTORY (assemble)")
    p.add_argument("--output")
    # -- assemble-only options (multi-host journal assembly) ----------------
    p.add_argument("--processes", type=int, default=None,
                   help="assemble: per-process journal count (default: "
                   "auto-detect corpus[.pN].journal files in --input)")
    p.add_argument("--blocks", type=int, default=None,
                   help="assemble: total block count (default: highest "
                   "journaled block id + 1; assembly fails listing any "
                   "missing ids)")
    # -- learn-only options (dictionary geometry + training knobs) ----------
    p.add_argument("--counts", default=None,
                   help="learn: comma-separated atoms per level, e.g. 32,16")
    p.add_argument("--scales", default=None,
                   help="learn: comma-separated atom extents (samples), "
                   "strictly increasing, e.g. 32,96")
    p.add_argument("--block-size", type=int, default=16384,
                   help="learn: samples per coded block")
    p.add_argument("--learn-coefs", default=None,
                   help="learn: per-level coefficient budgets (defaults to "
                   "block_size/32 per level)")
    p.add_argument("--algorithm", choices=["kmean", "samples"], default="kmean")
    p.add_argument("--num-windows", type=int, default=4096)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="learn: resume level-by-level from this directory")
    p.add_argument("--dict", dest="dict_path")
    p.add_argument("--backend", default="auto", choices=["auto", "torch", "cuda"],
                   help="'cuda': the hand-written kernels; 'torch': their "
                   "plain PyTorch versions; 'auto': 'cuda' on a CUDA device")
    p.add_argument("--device", default="cuda",
                   help="device of encode/decode/learn: 'cuda' (default; "
                   "exits if no card is visible), 'cuda:N' or 'cpu'")
    p.add_argument("--journal-dir", default=None)
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard encode/decode batches over a 'data' mesh of "
                   "N devices (containers/rows byte-identical to the local "
                   "path): the first N cards, or N shards with --device cpu")
    p.add_argument("--metrics", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--wav-rate", type=int, default=16000,
                   help="sample rate when --output ends in .wav")
    p.add_argument("--entropy", choices=["fixed", "rice"], default=None,
                   help="override the dictionary's stream entropy mode")
    p.add_argument("--num-select", type=int, default=None,
                   help="override selections per greedy sweep (nbBlocks)")
    p.add_argument("--num-coefs", type=int, default=None,
                   help="override the top-level coefficient budget")
    p.add_argument("--tolerance-snr", type=float, default=None,
                   help="stop encoding a block at this SNR (dB)")
    p.add_argument("--target-bps", type=float, default=None,
                   help="encode: constant-bitrate mode — keep the largest "
                   "greedy event prefixes whose packed payloads fit this "
                   "many bits/sample (the prefix property makes any prefix "
                   "a valid stream); --num-coefs stays the quality ceiling")
    p.add_argument("--rate-mode", choices=["block", "corpus"],
                   default="block",
                   help="how --target-bps is allocated: 'block' (default) "
                   "caps every block independently (hard per-block bound); "
                   "'corpus' spends one corpus-wide budget by marginal SNR "
                   "per byte — easy blocks donate spare bytes to hard ones "
                   "(+1 dB corpus SNR on mixed speech/music/silence "
                   "corpora; prefer 'block' for homogeneous material — "
                   "BASELINE 'Corpus-level CBR')")
    p.add_argument("--decode-mode", choices=["ordered", "integer"], default=None,
                   help="reconstruction arithmetic written into the stream "
                   "header: 'ordered' (sequential float32) or 'integer' "
                   "(order-free mod-2^32)")
    p.add_argument("--mmap", action="store_true",
                   help="memory-map the input instead of loading it — "
                   "encode: the .npy corpus (requires float32 whole-block "
                   "data); decode: the .hsct container (bounded memory for "
                   "huge corpora; pairs with --streaming/--range so only "
                   "the touched payloads are ever read)")
    p.add_argument("--streaming", action="store_true",
                   help="decode: write blocks to the output .npy one at a "
                   "time (bounded memory for huge corpora; byte-identical "
                   "output)")
    p.add_argument("--index", action="store_true",
                   help="encode: append the seek-index footer (O(1) random "
                   "access for decode --range; backward compatible — "
                   "footer-unaware decoders ignore it)")
    p.add_argument("--range", dest="block_range", default=None,
                   help="decode: only blocks A:B (python slice bounds, e.g. "
                   "'100:164') — random access via the seek index when "
                   "present, else one header scan; never unpacks the rest "
                   "of the corpus")
    p.add_argument("--distributed", action="store_true",
                   help="emit the distributed representation (events stored "
                   "at the level where their atom is raw) instead of "
                   "top-level-only streams; payload bits shrink under "
                   "entropy='fixed', but per-level stream headers (and "
                   "restarted rice deltas) can outweigh that on small "
                   "sparse blocks")
    return p.parse_args(argv)


def _read_container(path: str, use_mmap: bool):
    """Container bytes for decode/info: mmap'd (O(1) resident) or read."""
    if use_mmap:
        import mmap as _mmap

        f = open(path, "rb")
        return _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    with open(path, "rb") as f:
        return f.read()


def _device(args):
    """`--device` resolved for a verb that runs device work: no CPU fallback."""
    from .device import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--device {args.device}: {e}")


def main(argv=None):
    """Run one verb; `argv` defaults to the command line."""
    args = parse_args(argv)

    from . import MultilevelDictionary
    from .analysis import corpus_rates
    from .runtime import CorpusEncoder

    if args.command == "learn":
        _learn(args)
        return

    if args.command == "assemble":
        _assemble(args)
        return

    if args.command == "info":
        from .io import iter_blocks, peek_corpus_header, read_index

        blob = _read_container(args.input, args.mmap)
        cfg, n_blocks = peek_corpus_header(blob)
        # lazy walk: one block's events in memory at a time (info scales to
        # mmap'd containers of any size)
        rates = corpus_rates(cfg, iter_blocks(blob))
        print(json.dumps({
            "config": json.loads(cfg.to_json()),
            "blocks": n_blocks,
            "file_bytes": len(blob),
            "seek_index": read_index(blob) is not None,
            **{k: v for k, v in rates.items() if k != "per_level_payload_bits"},
            "per_level_payload_bits": {
                str(k): v for k, v in rates["per_level_payload_bits"].items()
            },
        }, indent=2))
        return

    if not args.dict_path:
        raise SystemExit("--dict is required for encode/decode")
    if not args.output:
        raise SystemExit("--output is required for encode/decode")
    mld = MultilevelDictionary.load(args.dict_path)
    overrides = {}
    if args.entropy is not None:
        overrides["entropy"] = args.entropy
    if args.num_select is not None:
        overrides["num_select"] = args.num_select
    if args.tolerance_snr is not None:
        overrides["tolerance_snr"] = args.tolerance_snr
    if args.decode_mode is not None:
        overrides["decode_mode"] = args.decode_mode
    if args.num_coefs is not None:
        nc = list(mld.config.num_coefs)
        nc[-1] = args.num_coefs
        overrides["num_coefs"] = tuple(nc)
    if overrides:
        import dataclasses

        cfg2 = dataclasses.replace(mld.config, **overrides)
        mld = MultilevelDictionary(cfg2, mld.dicts)
    device = _device(args)
    mesh = None
    if args.mesh is not None:
        import torch

        from .parallel import make_mesh

        if device.type == "cuda":
            # the first N visible cards, as the JAX CLI takes its first N devices
            visible = torch.cuda.device_count()
            if args.mesh > visible:
                raise SystemExit(f"--mesh {args.mesh}: only {visible} device(s) visible")
            devices = [f"cuda:{i}" for i in range(args.mesh)]
        else:
            # N shards on the CPU: the counterpart of JAX's virtual CPU devices
            devices = ["cpu"] * args.mesh
        mesh = make_mesh({"data": args.mesh}, devices=devices)
    codec = CorpusEncoder(
        mld,
        device=device,
        backend=args.backend,
        batch_size=args.batch_size,
        journal_dir=args.journal_dir,
        metrics_path=args.metrics,
        distributed=args.distributed,
        mesh=mesh,
        target_bps=args.target_bps,
        rate_mode=args.rate_mode,
    )

    if args.command == "encode":
        x = _load_corpus_blocks(
            args.input, mld.config.block_size, mmap=args.mmap
        )
        blob = codec.encode(x, index=args.index)
        with open(args.output, "wb") as f:
            f.write(blob)
        ratio = x.size * 4 / len(blob)
        print(f"{args.output}: {len(blob)} bytes ({ratio:.1f}x vs float32)")
    else:  # decode
        blob = _read_container(args.input, args.mmap)
        if args.block_range is not None:
            try:
                a_s, b_s = args.block_range.split(":")
                a, b = int(a_s), int(b_s)
            except ValueError:
                raise SystemExit("--range must be 'A:B' (block indices)")
            from .io import peek_corpus_header

            _, n_blocks = peek_corpus_header(blob)
            # python slice semantics, as advertised: negative bounds count
            # from the end, out-of-range bounds clamp — never a traceback
            indices = range(*slice(a, b).indices(n_blocks))
            if args.streaming:
                if not args.output.lower().endswith(".npy"):
                    raise SystemExit("--streaming requires a .npy --output")
                from numpy.lib.format import open_memmap

                mm = open_memmap(
                    args.output, mode="w+", dtype=np.float32,
                    shape=(len(indices), mld.config.block_size),
                )
                for i, row in enumerate(
                    codec.decode_stream(blob, indices=indices)
                ):
                    mm[i] = row
                mm.flush()
                print(f"{args.output}: {mm.shape} float32 "
                      f"(blocks {a}:{b}, streamed)")
                return
            out = codec.decode_blocks(blob, indices)
            if args.output.lower().endswith(".wav"):
                from .signal import save_wav

                save_wav(args.output, out, rate=args.wav_rate)
                print(f"{args.output}: {out.size} samples @ {args.wav_rate} "
                      f"Hz (blocks {a}:{b})")
            else:
                np.save(args.output, out)
                print(f"{args.output}: {out.shape} float32 (blocks {a}:{b})")
            return
        if args.streaming:
            if not args.output.lower().endswith(".npy"):
                raise SystemExit("--streaming requires a .npy --output")
            from numpy.lib.format import open_memmap

            from .io import peek_corpus_header

            scfg, n_blocks = peek_corpus_header(blob)  # O(header) peek
            mm = open_memmap(
                args.output, mode="w+", dtype=np.float32,
                shape=(n_blocks, scfg.block_size),
            )
            for b, row in enumerate(codec.decode_stream(blob)):
                mm[b] = row
            mm.flush()
            print(f"{args.output}: {mm.shape} float32 (streamed)")
            return
        out = codec.decode(blob)
        if args.output.lower().endswith(".wav"):
            from .signal import save_wav

            save_wav(args.output, out, rate=args.wav_rate)
            print(f"{args.output}: {out.size} samples @ {args.wav_rate} Hz")
        else:
            np.save(args.output, out)
            print(f"{args.output}: {out.shape} float32")


def _load_corpus_blocks(
    path: str, block_size: int, mmap: bool = False
) -> np.ndarray:
    """Load .npy/.wav input as ``[B, block_size]`` float32 blocks (1-D inputs
    are zero-padded into whole blocks — same convention as encode).

    ``mmap=True`` memory-maps the .npy instead of loading it (bounded-memory
    encode for huge corpora: the runtime copies one batch at a time to the
    device and never materializes the input).  Requires a float32 .npy whose
    length is already whole blocks — padding or dtype conversion would force
    the full copy the flag exists to avoid."""
    if path.lower().endswith(".wav"):
        from .signal import load_wav_blocks

        return load_wav_blocks(path, block_size)
    if mmap:
        x = np.load(path, mmap_mode="r")
        if x.dtype != np.float32:
            raise SystemExit(
                f"--mmap requires a float32 .npy (got {x.dtype}); "
                "convert once with numpy or drop --mmap"
            )
        if x.ndim == 1:
            if x.shape[0] % block_size:
                raise SystemExit(
                    f"--mmap requires whole blocks ({block_size} samples); "
                    f"input has {x.shape[0] % block_size} trailing samples — "
                    "pad the file once or drop --mmap"
                )
            x = x.reshape(-1, block_size)
        if x.shape[1] != block_size:
            raise SystemExit(
                f"corpus blocks are {x.shape[1]} samples; expected the codec "
                f"block size {block_size}"
            )
        return x
    x = np.load(path).astype(np.float32)
    if x.ndim == 1:
        nb = -(-x.shape[0] // block_size)
        padded = np.zeros(nb * block_size, np.float32)
        padded[: x.shape[0]] = x
        x = padded.reshape(nb, block_size)
    if x.shape[1] != block_size:
        raise SystemExit(
            f"corpus blocks are {x.shape[1]} samples; expected the codec "
            f"block size {block_size}"
        )
    return x


def _assemble(args) -> None:
    """Process-0 container assembly from per-process encode journals
    (SURVEY.md §2.3 P9).  The journal directory is self-describing: the
    codec config travels in ``corpus.config`` (written at journal creation,
    enforced on resume), and each process p journals under
    ``corpus[.pN].{journal,blocks}`` — so assembly needs no --dict and no
    out-of-band config.  Typical multi-host flow: every host runs
    ``encode --journal-dir SHARED_DIR`` on its shard, then any one host
    runs ``assemble --input SHARED_DIR --output corpus.hsct``."""
    import glob
    import os

    from .config import CodecConfig
    from .io.journal import EncodeJournal
    from .runtime import (
        _journal_name,
        assemble_container,
        parse_journal_fingerprint,
        parse_journal_name,
    )

    jdir = args.input
    # any process's .config carries the identical fingerprint — fall back
    # past corpus.config so a host-0 crash before its first block (no p0
    # files at all) still assembles the surviving journals
    cpaths = [os.path.join(jdir, "corpus.config")] + sorted(
        glob.glob(os.path.join(jdir, "corpus.p*.config"))
    )
    cpath = next(
        (p for p in cpaths if os.path.exists(p)), None
    ) if os.path.isdir(jdir) else None
    if cpath is None:
        raise SystemExit(
            f"{jdir!r} is not a journal directory (no corpus[.pN].config) — "
            "pass the --journal-dir an encode run wrote into"
        )
    if not args.output:
        raise SystemExit("--output is required for assemble")
    with open(cpath) as f:
        stored = f.read()
    # one parser for the fingerprint (config + :distributed + :cbr=...) —
    # runtime.journal_fingerprint is the one builder
    config_json, distributed, target_bps, rate_mode = (
        parse_journal_fingerprint(stored)
    )
    cfg = CodecConfig.from_json(config_json)
    # detect per-process journals by FILE, tolerating gaps (a host that died
    # before its first block leaves no file; its blocks surface in the
    # missing-ids error rather than being silently skipped past)
    idxs = []
    for f in glob.glob(os.path.join(jdir, "corpus*.journal")):
        idx = parse_journal_name(os.path.basename(f)[: -len(".journal")])
        if idx is not None:
            idxs.append(idx)
    if not idxs:
        raise SystemExit(f"no journal files found in {jdir!r}")
    n_proc = args.processes if args.processes is not None else max(idxs) + 1
    n_blocks = args.blocks
    if n_blocks is None:
        n_blocks = 0
        for p_idx in sorted(set(idxs)):
            # read-only probe: never creates or repairs files in the shared
            # dir (the EncodeJournal constructor opens append handles, which
            # would create a missing .blocks companion)
            done = EncodeJournal.peek_done_blocks(
                jdir, name=_journal_name(p_idx)
            )
            if done:
                n_blocks = max(n_blocks, max(done) + 1)
        if n_blocks == 0:
            raise SystemExit(f"no journaled blocks found in {jdir!r}")
    try:
        # the fingerprint is passed VERBATIM from the journal's .config —
        # rebuilding it from the parsed config would reject valid journals
        # if the JSON round trip ever stopped being byte-stable
        blob = assemble_container(
            cfg, jdir, n_blocks, n_proc,
            distributed=distributed, index=args.index,
            target_bps=target_bps, fingerprint=stored, rate_mode=rate_mode,
        )
    except ValueError as e:  # e.g. blocks missing from every journal
        raise SystemExit(str(e))
    with open(args.output, "wb") as f:
        f.write(blob)
    print(
        f"{args.output}: {len(blob)} bytes ({n_blocks} blocks from "
        f"{n_proc} process journal(s))"
    )


def _learn(args) -> None:
    """`learn` verb: the reference's multilevel training driver (SURVEY.md
    §3.5 — alternate ConvolutionalDictionaryLearner.train with MP encoding
    per level) producing a saved dictionary the encode/decode verbs consume."""
    from .config import CodecConfig
    from .learn.trainer import MultilevelTrainer

    if not args.output:
        raise SystemExit("--output (dictionary .npz path) is required for learn")
    if not args.counts or not args.scales:
        raise SystemExit("--counts and --scales are required for learn")
    counts = tuple(int(v) for v in args.counts.split(","))
    scales = tuple(int(v) for v in args.scales.split(","))
    if args.learn_coefs is not None:
        num_coefs = tuple(int(v) for v in args.learn_coefs.split(","))
    else:
        num_coefs = tuple(max(args.block_size // 32, 1) for _ in counts)
    if args.num_coefs is not None:
        # same semantics as the encode verb: --num-coefs sets the TOP-level
        # budget (per-level budgets via --learn-coefs)
        nc = list(num_coefs)
        nc[-1] = args.num_coefs
        num_coefs = tuple(nc)
    overrides = {}
    if args.entropy is not None:
        overrides["entropy"] = args.entropy
    if args.num_select is not None:
        overrides["num_select"] = args.num_select
    if args.decode_mode is not None:
        overrides["decode_mode"] = args.decode_mode
    cfg = CodecConfig(
        counts=counts,
        scales=scales,
        block_size=args.block_size,
        num_coefs=num_coefs,
        tolerance_snr=args.tolerance_snr,
        **overrides,
    )
    blocks = _load_corpus_blocks(args.input, cfg.block_size, mmap=args.mmap)
    trainer = MultilevelTrainer(
        cfg,
        algorithm=args.algorithm,
        num_windows=args.num_windows,
        iterations=args.iterations,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        device=_device(args),
    )
    mld = trainer.train(blocks)
    mld.save(args.output)
    print(
        f"{args.output}: {cfg.num_levels} level(s), counts={cfg.counts}, "
        f"scales={cfg.scales} (learned from {blocks.shape[0]} blocks)"
    )


if __name__ == "__main__":
    main()
