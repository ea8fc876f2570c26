"""Pre-commit smoke gate of the PyTorch / CUDA port: a few seconds of
critical-path checks on the CPU.

The counterpart of scripts/smoke.py.  Checks:
  1. the plain single-level encode bitwise the pinned oracle (the NumPy
     `mp_encode` with the port's own init injected), and the 2-level
     encode, int8 level-1 init included, every level likewise;
  2. the container pack -> unpack -> decode round trip in both decode
     modes, the decode bitwise the NumPy oracle;
  3. chip_smoke.py, scripts/torch_fuzz_parity.py, the experiment
     drivers (scripts/torch_run_experiment.py,
     scripts/torch_run_audio_experiment.py) and the measuring scripts
     (scripts/torch_bench_*.py) import, and the entry points chip_smoke.py
     calls resolve (the drivers' and the measuring scripts' `main`,
     `ops.mp_kernels.mp_loop`, `ops.decode_integer_kernel`,
     `ops.decode_kernel`, `ops.init_kernels.int8_init`, `_build`).

    python scripts/torch_smoke.py

Exit 0 = safe to commit.  It is neither the test suite
(tests/test_torch_*.py) nor the hardware gates (chip_smoke.py and
scripts/torch_fuzz_parity.py on the card).
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def check(cond, what) -> None:
    if not cond:
        raise RuntimeError(f"[smoke] FAIL: {what}")


def main() -> int:
    t_start = time.perf_counter()
    from hsc_torch import CorpusEncoder, MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.io import unpack_corpus
    from hsc_torch.models import ConvolutionalSparseCoder, HierarchicalConvolutionalSparseCoder
    from hsc_torch.oracle import mp_decode
    from hsc_torch.oracle.mp import mp_decode_integer, rep_quantize
    from hsc_torch.pinned import oracle_encode_pinned, oracle_hierarchical_pinned

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from torch_fuzz_parity import first_event_diff

    cfg = make_test_config()
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(2, cfg.block_size, seed=3)

    # -- 1. the plain encodes bitwise the pinned oracle ----------------------
    got = ConvolutionalSparseCoder(mld, device="cpu").encode_batch(xs)
    for b in range(2):
        want = oracle_encode_pinned(xs[b][:, None], mld, 0, "cpu")
        check(first_event_diff(got[b], want) is None and got[b].energy_res == np.float32(want.energy_res),
              f"flat block {b} != pinned oracle")
    hcfg = make_test_config(counts=(12, 6), scales=(12, 18), block_size=512, num_coefs=(40, 24))
    check(hcfg.hier_init == "int8", "the 2-level config resolved to hier_init f32")
    hmld = MultilevelDictionary.generate(hcfg, seed=7)
    hx = np.random.default_rng(5).standard_normal((2, hcfg.block_size)).astype(np.float32)
    hgot = HierarchicalConvolutionalSparseCoder(hmld, device="cpu").encode_batch(hx)
    for b in range(2):
        for g, w in zip(hgot[b], oracle_hierarchical_pinned(hx[b], hmld, "cpu")):
            check(first_event_diff(g, w) is None, f"2-level block {b} != pinned oracle")
    print(f"[smoke] 1/3 plain encodes (1 level; 2 levels, int8 init) bitwise vs pinned oracle ok "
          f"({time.perf_counter() - t_start:.1f}s)", flush=True)

    # -- 2. container round trip + oracle-bitwise decode, both modes --------
    for decode_mode in ("ordered", "integer"):
        mld_m = MultilevelDictionary(dataclasses.replace(cfg, decode_mode=decode_mode), mld.dicts)
        enc = CorpusEncoder(mld_m, device="cpu", batch_size=2)
        blob = enc.encode(xs)
        cfg_u, blocks = unpack_corpus(blob)
        check(cfg_u == mld_m.config and len(blocks) == len(xs), f"{decode_mode} container header")
        rows = enc.decode(blob)
        bank = mld.augmented(0)
        for b, block in enumerate(blocks):
            ((_, stream),) = block
            if decode_mode == "integer":
                rep_q, step = rep_quantize(bank, cfg.rep_bits)
                want = mp_decode_integer(stream, rep_q, step, cfg.block_size)
            else:
                want = mp_decode(stream, bank, cfg.block_size)
            check(rows[b].tobytes() == want[:, 0].tobytes(), f"{decode_mode} decode != oracle at block {b}")
    print(f"[smoke] 2/3 container round trip + oracle decode ok ({time.perf_counter() - t_start:.1f}s)",
          flush=True)

    # -- 3. the card scripts import and their kernel entry points resolve ---
    for mod, names in (
        ("chip_smoke", ("main", "gates", "odd_width_int_decode", "experiments", "measures", "flag_flips")),
        ("torch_fuzz_parity", ("run_shape", "run_hier_shape", "run_container_shape", "flat_parity")),
        ("torch_run_experiment", ("main", "parse_args")),
        ("torch_run_audio_experiment", ("main", "parse_args")),
        *((f"torch_bench_{name}", ("main", "parse_args", "measure"))
          for name in ("serving", "decode_marginal", "encode_stages", "hier_stages", "scaling")),
        ("hsc_torch.ops.mp_kernels", ("mp_loop",)),
        ("hsc_torch.ops.decode_integer_kernel", ("mp_decode_integer_batch",)),
        ("hsc_torch.ops.decode_kernel", ("mp_decode_batch",)),
        ("hsc_torch.ops.init_kernels", ("int8_init", "kernel_planes")),
        ("hsc_torch._build", ("load", "library_path")),
    ):
        m = importlib.import_module(mod)
        missing = [n for n in names if not callable(getattr(m, n, None))]
        check(not missing, f"{mod} lacks {missing}")
    print(f"[smoke] 3/3 chip_smoke / fuzz / experiment drivers / measuring scripts / kernel entry points resolve ({time.perf_counter() - t_start:.1f}s)",
          flush=True)
    print(f"[smoke] PASS in {time.perf_counter() - t_start:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
