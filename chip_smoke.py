#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py

At the flagship configuration (16384-sample blocks, 64 atoms of width 32,
512 coefficients, num_select=8, integer decode) it:

  1. requires a CUDA device and prints the card, power limit and toolchain;
  2. builds the hand-written kernels from hsc_torch/csrc;
  3. holds the init within 1e-5 of the oracle's correlation (TF32 off), and
     the greedy-loop kernel bitwise against its plain PyTorch version
     (num_select 8, 1 and 3, plus an SNR stop and an all-zero block) and two
     blocks per setting against the NumPy oracle with the port's init
     injected;
  4. holds the integer-decode kernel bitwise against its plain version and
     the oracle, including a batch whose sums wrap past 2^31;
  5. encodes 128 blocks with CorpusEncoder(device='cuda') twice (identical
     bytes), decodes them (bitwise the oracle's integer decode of the
     unpacked streams) and shows both kernels were launched on that path;
  6. times both kernels against their plain versions and the codec end to
     end on both backends (in turns, median and range), times the init, and
     profiles one encode and one decode (device-busy share and time by
     kernel; the traces go to build/chip_smoke/).

Every phase is fatal on failure.  The NumPy spec it checks against
(`hsc_tpu.oracle`, `hsc_tpu.io`) is shared with the JAX package and imports
no JAX; the script fails if JAX was imported.  The last line is one JSON
object with the device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = dict(
    counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,), num_select=8
)
N_BLOCKS = 128
BATCH = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, trace_path: str) -> dict:
    """Run `fn` under torch.profiler and read the device timeline back from
    its chrome trace: host wall ms, device-busy ms (union of kernel, memcpy
    and memset intervals), and device ms per kernel name."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            key = e["name"].replace("(anonymous namespace)::", "").split("(")[0][-40:]
            by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) / 1e3
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3, "by_name": by_name}


def fields_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def max_abs_diff(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0 for x, y in zip(a, b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch import _build
    from hsc_torch.ops import decode_integer_kernel, mp_kernels
    from hsc_torch.ops.decode import mp_decode_integer_batch_torch
    from hsc_torch.ops.encode import encode_init_batched, mp_encode_from_init_torch, quantizer_steps
    from hsc_torch.params import level_params_from_mld
    from hsc_torch.runtime import CorpusEncoder
    from hsc_tpu.io import unpack_corpus
    from hsc_tpu.oracle.mp import (
        LevelStream,
        correlate_bank,
        mp_decode_integer,
        mp_encode,
        rep_quantize,
    )
    from hsc_tpu.utils import snr_db

    # ---- 1. device and toolchain ------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"[1] nvcc: {run([_build._nvcc(), '--version']).splitlines()[-1]}")
    dev = torch.device("cuda")

    # ---- 2. build ----------------------------------------------------------
    _build.load()
    log(f"[2] built {_build.library_path()} in {_build.BUILD_SECONDS:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[2]   {line.strip()}")

    cfg = make_test_config(**FLAGSHIP)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(N_BLOCKS, cfg.block_size, seed=3)
    params = level_params_from_mld(mld, 0, dev)
    bank, gram = mld.augmented(0), mld.gram(0)
    settings = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits)

    # ---- 3. greedy-loop kernel vs plain version vs oracle ------------------
    xb = xs[:BATCH].copy()
    xb[BATCH - 1] = 0.0  # an all-zero block emits nothing
    s0, e0, peak = encode_init_batched(torch.from_numpy(xb[:, :, None]).to(dev), params.bank)
    sc_np, iv_np = quantizer_steps(peak.cpu().numpy(), cfg.amp_bits)
    scale, inv = torch.from_numpy(sc_np).to(dev), torch.from_numpy(iv_np).to(dev)
    s0_host, e0_host = s0.cpu().numpy(), e0.cpu().numpy()
    # the init runs in full f32 (TF32 off): within 1e-5 of the peak of the
    # oracle's NumPy correlation — TF32 would miss by ~1e-3
    for b in (0, 37):
        diff = float(np.abs(s0_host[b] - correlate_bank(xb[b][:, None], bank)).max())
        check(diff <= 1e-5 * float(peak[b]), f"init off the oracle by {diff:.3g} at block {b}")
        log(f"[3] init vs oracle correlation, block {b}: max |diff| / peak = {diff / float(peak[b]):.3g}")
    encodes = {}
    mp_err = 0.0
    for ns, tol in ((8, None), (1, None), (3, None), (8, 5.0)):
        kw = dict(settings, num_select=ns, tolerance_snr=tol)
        got = mp_kernels.mp_loop(s0, e0, scale, inv, params, **kw)
        ref = mp_encode_from_init_torch(s0, e0, scale, inv, params, **kw)
        torch.cuda.synchronize()
        check(torch.equal(s0.cpu(), torch.from_numpy(s0_host)), "mp_loop modified its scores0")
        check(fields_equal(got, ref), f"mp_encode kernel != plain at num_select={ns} tol={tol}")
        mp_err = max(mp_err, max_abs_diff(got, ref))
        check(int(got.count[BATCH - 1]) == 0, "all-zero block emitted events")
        for b in (0, 37):
            o = mp_encode(xb[b][:, None], bank, gram, scores0=s0_host[b], energy0=float(e0_host[b]),
                          num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, tolerance_snr=tol,
                          num_select=ns)
            n = int(got.count[b])
            check(n == o.positions.shape[0], f"oracle count {o.positions.shape[0]} != kernel {n} (ns={ns}, b={b})")
            for name, a in (("positions", got.positions), ("atoms", got.atoms), ("codes", got.codes)):
                check(np.array_equal(a[b, :n].cpu().numpy(), getattr(o, name)),
                      f"oracle {name} differ (ns={ns}, tol={tol}, b={b})")
        encodes[(ns, tol)] = got
        log(f"[3] mp_encode ns={ns} tol={tol}: kernel == plain bitwise (7 fields x {BATCH} blocks), "
            f"== oracle on 2 blocks; mean events {float(got.count.float().mean()):.1f}")
    enc = encodes[(8, None)]

    # ---- 4. integer-decode kernel vs plain version vs oracle ---------------
    rep_q, step = params.rep_q, params.rep_step
    amp = torch.from_numpy((sc_np * np.float32(step)).astype(np.float32)).to(dev)
    dec_args = (enc.positions, enc.atoms, enc.codes, enc.count, amp, rep_q)
    got = decode_integer_kernel.mp_decode_integer_batch(*dec_args, n=cfg.block_size)
    ref = mp_decode_integer_batch_torch(*dec_args, n=cfg.block_size)
    check(torch.equal(got, ref), "int_decode kernel != plain")
    rep_np = rep_q.cpu().numpy()
    host = [a.cpu().numpy() for a in enc]
    for b in range(BATCH):
        n = int(host[3][b])
        st = LevelStream(host[0][b, :n], host[1][b, :n], host[2][b, :n], np.float32(sc_np[b]), 0.0, 0.0)
        check(got[b].cpu().numpy().tobytes() == mp_decode_integer(st, rep_np, step, cfg.block_size).tobytes(),
              f"int_decode != oracle at block {b}")
    # adversarial wrap: 512 max codes x max rep codes at one position
    wrap_rep = np.full((2, 32, 1), 4095, np.int32)
    wrap_rep[1] *= -1
    m = cfg.num_coefs[0]
    wpos = np.zeros((2, m), np.int32)
    wpos[1] = np.arange(m) % 97
    watm = np.stack([np.zeros(m, np.int32), np.arange(m, dtype=np.int32) % 2])
    wcds = np.full((2, m), 32767, np.int32)
    wcnt = np.array([m, m - 5], np.int32)
    wamp = np.array([2e-8, 3e-8], np.float32)
    t_args = [torch.from_numpy(a).to(dev) for a in (wpos, watm, wcds, wcnt, wamp, wrap_rep)]
    got_w = decode_integer_kernel.mp_decode_integer_batch(*t_args, n=cfg.block_size)
    check(torch.equal(got_w, mp_decode_integer_batch_torch(*t_args, n=cfg.block_size)),
          "int_decode kernel != plain on the wraparound batch")
    for b in range(2):
        st = LevelStream(wpos[b, :wcnt[b]], watm[b, :wcnt[b]], wcds[b, :wcnt[b]], np.float32(1), 0.0, 0.0)
        o = mp_decode_integer(st, wrap_rep, wamp[b], cfg.block_size)
        check(got_w[b].cpu().numpy().tobytes() == o.tobytes(), f"wraparound block {b} != oracle")
    check(bool((got_w[0] < 0).any()), "the wraparound batch did not wrap")
    dec_err = max_abs_diff([got, got_w], [ref, mp_decode_integer_batch_torch(*t_args, n=cfg.block_size)])
    log(f"[4] int_decode: kernel == plain == oracle bitwise on {BATCH} encoded blocks and a wrapping batch")

    # ---- 5. the main path, counted -----------------------------------------
    codec = CorpusEncoder(mld, device="cuda")
    mp_kernels.LAUNCHES = 0
    decode_integer_kernel.LAUNCHES = 0
    blob = codec.encode(xs)
    blob2 = codec.encode(xs)
    decoded = codec.decode(blob)
    launches = {"mp_encode": mp_kernels.LAUNCHES, "int_decode": decode_integer_kernel.LAUNCHES}
    log(f"[5] launches on the main path: {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel of the main path was never launched")
    check(blob == blob2, "two encodes of one corpus gave different bytes")
    check(decoded.shape == (N_BLOCKS, cfg.block_size) and np.isfinite(decoded).all(), "bad decode output")
    hdr_cfg, blocks = unpack_corpus(blob)
    rep_o, step_o = rep_quantize(mld.representations(0)[:, :, None], hdr_cfg.rep_bits)
    check(hdr_cfg.decode_mode == "integer", "flagship did not resolve to integer decode")
    for b, streams in enumerate(blocks):
        (level, st), = streams
        check(decoded[b].tobytes() == mp_decode_integer(st, rep_o, step_o, cfg.block_size)[:, 0].tobytes(),
              f"main-path decode != oracle at block {b}")
    events = sum(int(s[0][1].positions.shape[0]) for s in blocks)
    snr = float(np.mean([snr_db(xs[b], decoded[b]) for b in range(N_BLOCKS)]))
    ratio = xs.nbytes / len(blob)
    log(f"[5] {N_BLOCKS} blocks -> {len(blob)} bytes: ratio {ratio:.2f}x, {events} events, "
        f"mean SNR {snr:.3f} dB; decode bitwise the oracle")

    # ---- 6. timing: plain and kernel in turns (P K K P ...), median [range] --
    def turns(kernel_fn, plain_fn, rounds: int):
        k, p = [], []
        for r in range(rounds):
            for fn in ((plain_fn, kernel_fn) if r % 2 == 0 else (kernel_fn, plain_fn)):
                (p if fn is plain_fn else k).append(fn())
        return k, p

    def wall_s(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def stats(v, unit: str, fmt: str = ".4f") -> str:
        return f"{statistics.median(v):{fmt}} {unit} [{min(v):{fmt}}..{max(v):{fmt}}, n={len(v)}]"

    kw8 = dict(settings, num_select=8)
    mp_k, mp_p = turns(lambda: cuda_ms(lambda: mp_kernels.mp_loop(s0, e0, scale, inv, params, **kw8), 3),
                       lambda: cuda_ms(lambda: mp_encode_from_init_torch(s0, e0, scale, inv, params, **kw8), 1),
                       4)
    dec_k, dec_p = turns(
        lambda: cuda_ms(lambda: decode_integer_kernel.mp_decode_integer_batch(*dec_args, n=cfg.block_size), 50),
        lambda: cuda_ms(lambda: mp_decode_integer_batch_torch(*dec_args, n=cfg.block_size), 10), 4)
    mb = N_BLOCKS * cfg.block_size * 4 / 1e6
    plain = CorpusEncoder(mld, device="cuda", backend="torch")
    check(plain.encode(xs) == blob, "backend='torch' container != backend='cuda' container")
    check(plain.decode(blob).tobytes() == decoded.tobytes(), "backend='torch' decode != backend='cuda' decode")
    enc_k, enc_p = turns(lambda: mb / wall_s(lambda: codec.encode(xs)),
                         lambda: mb / wall_s(lambda: plain.encode(xs)), 2)
    dc_k, dc_p = turns(lambda: mb / wall_s(lambda: codec.decode(blob)),
                       lambda: mb / wall_s(lambda: plain.decode(blob)), 4)
    mp_ms, mp_plain_ms = statistics.median(mp_k), statistics.median(mp_p)
    dec_ms, dec_plain_ms = statistics.median(dec_k), statistics.median(dec_p)
    log(f"[6] card {card}")
    log(f"[6] greedy loop, one {BATCH}-block batch (ns=8): kernel {stats(mp_k, 'ms')}, plain {stats(mp_p, 'ms')}")
    log(f"[6] integer decode, one {BATCH}-block batch: kernel {stats(dec_k, 'ms')}, plain {stats(dec_p, 'ms')}")
    log(f"[6] CorpusEncoder.encode, {N_BLOCKS} blocks, host wall: cuda {stats(enc_k, 'MB/s', '.2f')}, "
        f"torch {stats(enc_p, 'MB/s', '.2f')}")
    log(f"[6] CorpusEncoder.decode, {N_BLOCKS} blocks, host wall: cuda {stats(dc_k, 'MB/s', '.2f')}, "
        f"torch {stats(dc_p, 'MB/s', '.2f')}")
    log(f"[6] device-only rates: greedy loop {BATCH * cfg.block_size * 4 / 1e3 / mp_ms:.2f} MB/s, "
        f"integer decode {BATCH * cfg.block_size * 4 / 1e3 / dec_ms:.2f} MB/s")
    x_dev = torch.from_numpy(xb[:, :, None]).to(dev)
    init_ms = cuda_ms(lambda: encode_init_batched(x_dev, params.bank), 5)
    log(f"[6] init (conv + energy + peak), one {BATCH}-block batch: {init_ms:.3f} ms")
    for what, fn in (("encode", lambda: codec.encode(xs)), ("decode", lambda: codec.decode(blob))):
        prof = device_profile(fn, f"build/chip_smoke/trace_{what}.json")
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:5]
        log(f"[6] profiled {what}: wall {prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms "
            f"(idle {100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}%); device ms by name: "
            + ", ".join(f"{k} {v:.3f}" for k, v in top))

    check("jax" not in sys.modules, "JAX was imported")
    kernels = [
        {"name": "mp_encode", "route": "cuda", "source": "hsc_torch/csrc/mp_encode.cu",
         "replaces": "hsc_tpu/ops/mp_kernels.py:83", "launches": launches["mp_encode"],
         "max_abs_err": mp_err,
         "ms": mp_ms, "plain_ms": mp_plain_ms},
        {"name": "int_decode", "route": "cuda", "source": "hsc_torch/csrc/int_decode.cu",
         "replaces": "hsc_tpu/ops/decode_integer_kernel.py:61", "launches": launches["int_decode"],
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
