#!/usr/bin/env python3
"""Smoke run of repro_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Phases, each of which fails the run (non-zero exit) on any error:

1. card: print the GPU's name and power limit (``nvidia-smi``);
2. build: compile the hand-written CUDA kernels of ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build time;
3. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it and at ragged, seam, windowed,
   top-left-causal and extreme-logit shapes, and time both (and, where one
   PyTorch call computes the same function, that call);
4. storage path: drive the CoARESECF storage path of the paper's Emulab
   deployment (n=11, k=6, EC-DAPopt, fragmented, indexed; 512 KiB min/avg
   and 1 MiB max blocks; one file of ``--size-mib`` MiB made from ``--seed``)
   through ``DSS`` and ``Session``: write, read, degraded read with a data
   server down, a 16-byte edit, stat, recovery + repair, recon to a fresh EC
   configuration, read. The bytes must come back equal after every step,
   both kernels' launch counts must grow where the step runs them, and no
   quorum round may be left stuck. The path then runs once more under
   ``cProfile`` and ``torch.profiler`` for a host/device breakdown (the
   device's busy share, the costliest host functions; files in ``--out``).
   The same sequence on a small file must give the same bytes and the same
   trace on the card as with the plain versions on the CPU;
5. model path: qwen2-0.5b at full width and depth (24 layers, random
   weights from ``torch.Generator().manual_seed(--seed)``): a prefill of
   4 x 2048 tokens through ``make_prefill_step`` (one flash-attention launch
   per layer), then ``repro_torch.launch.serve`` with ``--full --batch 4
   --cache-len 2048 --tokens 32``. Logits must be finite. The same prefill
   at full width, 2 layers and 256 tokens, and one decode step from one
   cache, must agree between the card (kernel) and the CPU (plain versions).

The line before the last holds the kernels' launches and times, the last
line ``{"ok": true, "device": {...}}``. With no CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py [--seed 0] [--size-mib 512] [--out chiprun_out/chip_smoke]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
MIN_BLOCK, AVG_BLOCK, MAX_BLOCK = 512 << 10, 512 << 10, 1 << 20  # the paper's own
SMALL_FILE = 3 << 20  # the file of the card-vs-CPU trace check


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2
def build(out_dir: Path) -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(
        "".join(f"== {name}\n{text}\n" for name, text in logs.items())
    )
    log(f"build: {len(logs)} kernel libraries in {dt:.3f} s "
        f"({', '.join(_build.library_path(n).name for n in logs)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def _u8_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max()) if a.numel() else 0


def _u32_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if not a.numel():
        return 0
    m = 0xFFFFFFFF
    a64 = a.view(torch.int32).to(torch.int64) & m
    b64 = b.view(torch.int32).to(torch.int64) & m
    return int((a64 - b64).abs().max())


def check_gf256(path_L: int, rng: np.random.Generator, card: str) -> dict:
    from repro_torch.erasure.rs import _decoder_cached, _parity_cached
    from repro_torch.kernels.gf256_matmul import ops as gf
    from repro_torch.kernels.gf256_matmul.ref import gf256_matmul_ref

    dev = torch.device("cuda")
    n, k = 11, 6
    enc = _parity_cached(n, k)                         # (5, 6): every encode
    dec = _decoder_cached(n, k, tuple(range(1, 7)))    # (6, 6): decode without s0
    worst = 0
    cases = [(enc, path_L), (dec, path_L)]
    for L in (1, 7, 15, 16, 17, 4095, 4096, 4097, 1_000_003):   # ragged and misaligned
        cases.append((enc, L))
    cases.append((rng.integers(0, 256, (16, 16), dtype=np.uint8), 65_537))
    cases.append((rng.integers(0, 256, (256, 256), dtype=np.uint8), 4_099))  # > 48 KiB of A logs
    special = np.array([[0, 1, 2, 255], [128, 0, 3, 1]], dtype=np.uint8)       # edge values
    cases.append((special, 33))
    for A, L in cases:
        B = torch.from_numpy(rng.integers(0, 256, (A.shape[1], L), dtype=np.uint8)).to(dev)
        if A is special:
            B[:, :8] = torch.tensor([0, 1, 2, 255, 128, 254, 0, 3], dtype=torch.uint8)
        got = gf.gf256_matmul(A, B)
        torch.cuda.synchronize()
        want = gf256_matmul_ref(torch.from_numpy(A), B)
        err = _u8_err(got, want)
        if err or got.shape != want.shape:
            raise AssertionError(
                f"gf256_matmul {A.shape} x (.., {L}) differs from the plain version")
        worst = max(worst, err)
    before = gf.launches
    for A, L in ((np.zeros((0, 6), np.uint8), 100), (np.zeros((5, 0), np.uint8), 100), (enc, 0)):
        out = gf.gf256_matmul(A, torch.zeros((A.shape[1], L), dtype=torch.uint8, device=dev))
        if out.shape != (A.shape[0], L) or out.numel() and int(out.max()):
            raise AssertionError(f"degenerate gf256_matmul {A.shape} x (.., {L}) is not zeros")
    if gf.launches != before:
        raise AssertionError("a degenerate gf256_matmul launched the kernel")
    log(f"kernels: gf256_matmul byte-identical (tolerance 0) to the plain version on "
        f"{len(cases)} shapes (encode and decode at L={path_L}) and 3 degenerate ones")

    timings = {}
    for label, A in (("encode", enc), ("decode", dec)):
        B = torch.from_numpy(rng.integers(0, 256, (A.shape[1], path_L), dtype=np.uint8)).to(dev)
        At = torch.from_numpy(A)
        ms = cuda_ms(lambda: gf.gf256_matmul(A, B), 20)
        plain_ms = cuda_ms(lambda: gf256_matmul_ref(At, B), 2)
        bound_ms = (A.shape[0] + A.shape[1]) * path_L / HBM_BYTES_PER_S * 1e3
        timings[label] = (ms, plain_ms, bound_ms)
        log(f"kernels: gf256_matmul {label} {A.shape} x (6, {path_L}): {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes) ({card})")
        del B
    ms, plain_ms, bound_ms = timings["encode"]
    return {"name": "gf256_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/gf256_matmul.cu",
            "replaces": "src/repro/kernels/gf256_matmul/kernel.py:67",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def check_gearhash(data: np.ndarray, rng: np.random.Generator, card: str) -> dict:
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.cdc_gearhash.ref import gearhash_ref

    dev = torch.device("cuda")
    path_mask = cdc._mask_for_avg(AVG_BLOCK)
    worst = 0
    seam = np.zeros(3 * 2048 + 77, dtype=np.uint8)       # zeros across tile seams
    seam[2040:2060] = rng.integers(0, 256, 20, dtype=np.uint8)
    cases = [(data, path_mask), (data[: 64 << 20], 0xFFFF), (seam, 0xFFFF), (seam, 0),
             (seam, 0xFFFFFFFF)]
    for L in (1, 31, 32, 33, 2047, 2048, 2049, 4127):
        cases.append((rng.integers(0, 256, L, dtype=np.uint8), 0xFF))
    for arr, mask in cases:
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        h, b = cdc.gearhash(x, mask=mask)
        torch.cuda.synchronize()
        hr, br = gearhash_ref(x, mask=mask)
        err = max(_u32_err(h, hr), _u8_err(b, br))
        if err:
            raise AssertionError(
                f"gearhash at L={x.shape[0]} mask={mask:#x} differs from the plain version")
        worst = max(worst, err)
        del x, h, b, hr, br
    log(f"kernels: gearhash hash and bitmap byte-identical (tolerance 0) to the plain version on "
        f"{len(cases)} inputs (the path's {data.size} bytes, position 0, tile seams)")
    x = torch.from_numpy(data).to(dev)
    ms = cuda_ms(lambda: cdc.gearhash(x, mask=path_mask), 20)
    plain_ms = cuda_ms(lambda: gearhash_ref(x, mask=path_mask), 2)
    bound_ms = 6 * data.size / HBM_BYTES_PER_S * 1e3  # 1 byte in, 4 + 1 out
    log(f"kernels: gearhash L={data.size}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (bytes) ({card})")
    return {"name": "cdc_gearhash", "route": "cuda",
            "source": "src/repro_torch/csrc/cdc_gearhash.cu",
            "replaces": "src/repro/kernels/cdc_gearhash/kernel.py:58",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


PREFILL_B, PREFILL_S = 4, 2048  # the model path's prefill: its flash kernel's shape
FLASH_CASES = (
    # (label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, input scale)
    ("path", PREFILL_B, 14, 2, PREFILL_S, PREFILL_S, 64, True, 0, torch.bfloat16, 1.0),
    ("sliding window", 1, 4, 1, 2048, 2048, 256, True, 512, torch.bfloat16, 1.0),
    ("f32 Sq<Sk top-left causal", 2, 4, 2, 320, 1111, 128, True, 0, torch.float32, 1.0),
    ("extreme logits x30", 1, 2, 2, 256, 256, 32, True, 0, torch.float32, 30.0),
)
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _causal_pairs(Sq: int, Sk: int) -> int:
    """Unmasked (q, k) pairs of one head under the top-left causal mask."""
    full = min(Sq, Sk)
    return full * (full + 1) // 2 + max(0, Sq - Sk) * Sk


def check_flash(rng: np.random.Generator, card: str) -> dict:
    """The flash-attention kernel against its plain version on the cases
    above (tolerance 2e-2 in bf16: one bf16 rounding of outputs near 1;
    1e-4 in f32: sums in another order), then timed at the path's shape
    beside its plain version and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    worst = 0.0
    for label, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, scale in FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                   for shape in ((B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
        q, k, v = (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {label}: max |err| {err} > {tol}")
        log(f"kernels: flash_attention {label} q{tuple(q.shape)} k{tuple(k.shape)} "
            f"{str(dtype).removeprefix('torch.')} causal={causal} window={window}: "
            f"max |err| {err:.3e} (tolerance {tol})")
        worst = max(worst, err) if label == "path" else worst
        del q, k, v, got, want

    _, B, H, Hkv, Sq, Sk, hd, causal, window, dtype, _ = FLASH_CASES[0]
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
               for shape in ((B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
    ke, ve = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), 2)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True), 20)
    flops = 4 * hd * _causal_pairs(Sq, Sk) * B * H
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v in; o out
    flop_ms, byte_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes"
    log(f"kernels: flash_attention path q{tuple(q.shape)} k/v{tuple(k.shape)} bf16 causal: "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {flops} flops at 989 TFLOP/s = {flop_ms:.4f} ms, "
        f"{nbytes} bytes at 3.35 TB/s = {byte_ms:.4f} ms); {flops / ms / 1e9:.1f} TFLOP/s "
        f"({card})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------- phase 4
def drive_path(data: bytes, *, device: str, seed: int, quiet: bool = False,
               card: str = "") -> dict:
    """The quickstart sequence on the Emulab deployment; returns what it saw.
    Raises on a wrong byte, a kernel that a step should run but did not, or
    a stuck quorum round."""
    from repro_torch.configs.paper_store import EMULAB, make_dss
    from repro_torch.core import gather
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf

    on_card = device == "cuda"
    say = (lambda *a: None) if quiet else log
    dss = make_dss(EMULAB, seed=seed, indexed=True, coding_backend="kernel", device=device,
                   min_block=MIN_BLOCK, avg_block=AVG_BLOCK, max_block=MAX_BLOCK)
    alice, bob, admin = dss.session("alice"), dss.session("bob"), dss.session("admin")
    seen: dict = {"steps": {}}

    def step(name: str, fn, *, cdc_runs: bool, gf_runs: bool):
        c0, g0 = cdc.launches, gf.launches
        t0 = time.perf_counter()
        out = fn()
        dss.net.run()  # drain background traffic (the recon's repair pass) before checking
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dc, dg = cdc.launches - c0, gf.launches - g0
        if on_card and ((cdc_runs and not dc) or (gf_runs and not dg)):
            raise AssertionError(f"{name}: expected kernel launches, got cdc={dc} gf={dg}")
        stuck = dss.net.stuck_ops()
        if stuck:
            raise AssertionError(f"{name}: stuck quorum rounds {stuck!r}")
        seen["steps"][name] = {"wall_s": dt, "cdc_launches": dc, "gf_launches": dg}
        say(f"path: {name}: {dt:.3f} s wall, launches cdc_gearhash +{dc} gf256_matmul +{dg}"
            + (f" ({card})" if card else ""))
        return out

    fid = "object.bin"

    def write_first():
        fut = alice.write(fid, data)
        st = gather(fut)[0]
        seen["write"] = (st, fut.stats)
        return st

    st = step("write", write_first, cdc_runs=True, gf_runs=True)
    say(f"path: write: {st['blocks']} blocks, {seen['write'][1]}")

    def read_back(tag, reader=bob):
        fut = reader.read(fid)
        got = fut.result()
        if got != want[0]:
            raise AssertionError(f"{tag}: read bytes differ from what was written")
        seen.setdefault("reads", []).append(fut.stats)

    want = [data]
    step("read", lambda: read_back("read"), cdc_runs=False, gf_runs=False)
    dss.crash_servers(["s0"])  # holds data fragment 0: reads must decode
    # a reader that holds no copy yet: EC-DAPopt ships no data to a client
    # that already has the newest tag, so bob would not decode here
    carol = dss.session("carol")
    step("degraded read (s0 down)", lambda: read_back("degraded read", carol),
         cdc_runs=False, gf_runs=True)

    edited = bytearray(data)
    at = len(data) // 2
    edited[at:at + 16] = b"EDITED-IN-PLACE!"
    want[0] = bytes(edited)
    st2 = step("edit 16 bytes", lambda: alice.write(fid, want[0]).result(),
               cdc_runs=True, gf_runs=True)
    if not st2["written"] < st2["blocks"]:
        raise AssertionError(f"edit rewrote every block: {st2}")
    say(f"path: edit: rewrote {st2['written']}/{st2['blocks']} blocks")
    seen["edit"] = st2
    step("read after edit", lambda: read_back("read after edit"), cdc_runs=False, gf_runs=True)

    margin_down = step("stat", lambda: alice.stat(fid).result()["margin"],
                       cdc_runs=False, gf_runs=False)
    dss.recover_servers(["s0"])
    rep = step("recover s0 + repair", lambda: dss.repair(), cdc_runs=False, gf_runs=True)
    margin_up = alice.stat(fid).result()["margin"]
    if not margin_up > margin_down:
        raise AssertionError(f"repair did not restore the margin: {margin_down} -> {margin_up}")
    say(f"path: stat margin {margin_down} with s0 down, {margin_up} after repair "
        f"({len(rep)} objects repaired)")
    seen["margins"] = (margin_down, margin_up)

    cfg = dss.make_config(n_servers=EMULAB.n_servers, parity_m=EMULAB.parity_m,
                          fresh_servers=True)
    moved = step("recon to a fresh EC config", lambda: admin.recon(fid, cfg).result(),
                 cdc_runs=False, gf_runs=True)
    step("read after recon", lambda: read_back("read after recon"), cdc_runs=False, gf_runs=False)
    say(f"path: recon moved {moved['blocks']} blocks to {cfg.cfg_id} {cfg.servers}")
    n = dss.net
    seen["fingerprint"] = (n.now, n.events_processed, n.rpc_rounds, n.msg_count, n.bytes_sent,
                           n.client_counters)
    seen["moved"] = moved
    return seen


KERNEL_KINDS = (  # (kind, substrings of the kernel's name), first match wins
    ("flash_attention", ("flash_fwd",)), ("gf256_matmul", ("gf256_matmul",)),
    ("cdc_gearhash", ("gearhash",)), ("cuBLAS GEMM", ("nvjet", "gemm", "Gemv", "cutlass")),
    ("copies and casts", ("copy",)),
)


def _kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other elementwise and reductions"


def device_busy(prof, trace: Path, wall: float, tag: str) -> None:
    """Write ``prof``'s trace to ``trace`` and print the device's busy time
    (kernels + copies + fills, summed from the trace) against ``wall``, its
    split by kind of kernel, and the costliest kernels."""
    prof.export_chrome_trace(str(trace))
    busy: dict[str, float] = {}
    kinds: dict[str, list] = {}
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        cat = ev.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = ev["name"] if cat == "kernel" else cat
            sec = ev.get("dur", 0.0) * 1e-6
            busy[key] = busy.get(key, 0.0) + sec
            kind = kinds.setdefault(_kind(key) if cat == "kernel" else cat, [0.0, 0])
            kind[0] += sec
            kind[1] += 1
    total = sum(busy.values())
    log(f"{tag} device busy {total:.6f} s of {wall:.6f} s wall under the profiler "
        f"({100 * total / wall:.3f} %; idle {100 - 100 * total / wall:.3f} %), "
        f"{sum(n for _, n in kinds.values())} device operations")
    for kind, (sec, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"{tag} by kind {sec:.6f} s ({100 * sec / total:.2f} % of busy) in {n}: {kind}")
    for key, sec in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{tag} device {sec:.6f} s ({100 * sec / total:.2f} % of busy) {key[:90]}")


def profile_path(data: bytes, out_dir: Path, seed: int) -> None:
    """The main path once more, under ``cProfile`` (host) and
    ``torch.profiler`` (device). Writes ``host_profile.txt`` and
    ``path_trace.json`` to ``out_dir`` and prints the device's busy share
    (kernels + copies + fills, summed from the trace) of the wall time and
    the host functions that took the most time."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as dev:
        t0 = time.perf_counter()
        host.enable()
        drive_path(data, device="cuda", seed=seed, quiet=True)
        host.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_busy(dev, out_dir / "path_trace.json", wall, "profile:")
    text = io.StringIO()
    stats = pstats.Stats(host, stream=text)
    stats.sort_stats("tottime").print_stats(40)
    (out_dir / "host_profile.txt").write_text(text.getvalue())
    for (file, line, fn), row in stats.stats.items():
        if fn in ("gf256_coding_matmul", "split_chunks", "encode_bytes_batch",
                  "decode_bytes_batch") or fn.endswith(("crc32>", "sha1>")):
            log(f"profile: data plane {row[3]:.3f} s cumulative, {row[1]} calls: {fn}")
    for (file, line, fn), row in sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]:
        log(f"profile: host {row[2]:.3f} s self, {row[3]:.3f} s cumulative, {row[1]} calls: "
            f"{Path(file).name}:{line} {fn}")


# ---------------------------------------------------------------- phase 5
MODEL = "qwen2_0_5b"
SERVE_ARGS = ["--arch", MODEL, "--full", "--batch", "4", "--cache-len", "2048", "--tokens", "32"]
PREFILL_RUNS = 3
# card vs CPU: qwen2-0.5b at full width, 2 layers, B=2 x 256 tokens. The
# two devices round the bf16 matmuls after sums in another order; through
# 2 layers that moves logits (|logit| < ~0.5 here) by a few bf16 ulps.
SMALL_LAYERS, SMALL_B, SMALL_S = 2, 2, 256
SMALL_ATOL = 16 * 2.0**-10   # 8 bf16 ulps at |logit| in [0.25, 0.5)
SMALL_ARGMAX_SHARE = 0.9     # greedy tokens agreeing over all B x S positions


def drive_model(seed: int, card: str, out_dir: Path) -> int:
    """qwen2-0.5b at full width and depth: PREFILL_RUNS timed prefills of
    PREFILL_B x PREFILL_S tokens (after one warm-up, which is not counted),
    then the serve CLI's greedy decode, then a profile of both. Returns the
    flash_attention launches of the timed prefills and the decode."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step

    cfg = get_arch(MODEL)
    t0 = time.perf_counter()
    model = build_model(cfg, max_pos=PREFILL_S, device="cuda")
    params = model.load_params(model.init_params(torch.Generator().manual_seed(seed)))
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {model.n_params()} parameters, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"random weights (seed {seed}) made in {time.perf_counter() - t0:.3f} s")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S), dtype=np.int32)).to("cuda")
    step = make_prefill_step(model)
    step(params, {"tokens": tokens})  # warm-up: cuBLAS handles, kernel library load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    walls = []
    for _ in range(PREFILL_RUNS):
        t0 = time.perf_counter()
        logits = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prefill_launches = fa.launches
    if prefill_launches != PREFILL_RUNS * cfg.n_layers:
        raise AssertionError(f"{PREFILL_RUNS} prefills launched flash_attention "
                             f"{prefill_launches} times, not {PREFILL_RUNS} x {cfg.n_layers}")
    if logits.shape != (PREFILL_B, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are not finite (B, V)")
    wall = sorted(walls)[len(walls) // 2]
    log(f"model: prefill {PREFILL_B} x {PREFILL_S} tokens: {wall:.4f} s wall (median of "
        f"{', '.join(f'{w:.4f}' for w in walls)}), {PREFILL_B * PREFILL_S / wall:.1f} tokens/s, "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes, flash_attention "
        f"launches {prefill_launches} ({cfg.n_layers} per prefill) ({card})")

    torch.cuda.reset_peak_memory_stats()
    out = serve.main(SERVE_ARGS + ["--seed", str(seed)])
    launches = fa.launches
    if not out["finite"] or out["tokens"].shape != (4, 32):
        raise AssertionError(f"serve: logits finite {out['finite']}, tokens {out['tokens'].shape}")
    decode_tps = out["tokens"].size / out["seconds"]
    log(f"model: serve {' '.join(SERVE_ARGS)}: {out['seconds']:.4f} s after a "
        f"{out['warmup_seconds']:.4f} s warm-up step, {decode_tps:.1f} tokens/s, "
        f"{1e3 * out['seconds'] / 32:.3f} ms per step, peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes, flash_attention launches "
        f"+{launches - prefill_launches} (decode attends with the plain gqa_attention) ({card})")
    profile_model(model, params, tokens, out_dir)
    del model, params, logits, step
    torch.cuda.empty_cache()
    return launches


def profile_model(model, params, tokens: torch.Tensor, out_dir: Path) -> None:
    """One prefill and 8 decode steps (from a zero cache of the serve
    phase's length) under ``torch.profiler``: the device's busy share and
    the costliest kernels of each; traces in ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import decode_loop
    from repro_torch.train.steps import make_prefill_step

    step = make_prefill_step(model)
    B = tokens.shape[0]
    first = {"token": tokens[:, 0].contiguous()}
    runs = (("prefill", lambda: step(params, {"tokens": tokens})),
            ("decode x8", lambda: decode_loop(model, params, model.init_cache(B, PREFILL_S),
                                              dict(first), 8)))
    for label, fn in runs:
        fn()  # warm-up outside the profiler
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_busy(prof, out_dir / f"model_{label.split()[0]}_trace.json", wall,
                    f"profile {label}:")


def card_vs_cpu(seed: int) -> None:
    """The same prefill and one decode step on the card and on the CPU, with
    the same weights (one seeded CPU generator) and inputs."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_arch(MODEL), n_layers=SMALL_LAYERS)
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (SMALL_B, SMALL_S), dtype=np.int32))
    cache_shape = (SMALL_LAYERS, SMALL_B, SMALL_S, cfg.n_kv_heads, cfg.hd)
    cache_np = {name: rng.standard_normal(cache_shape, dtype=np.float32) for name in ("k", "v")}
    cur = SMALL_S // 2
    seen = {}
    for where in ("cuda", "cpu"):
        model = build_model(cfg, device=where)
        dev = model.device
        params = model.load_params(model.init_params(torch.Generator().manual_seed(seed)))
        last = make_prefill_step(model)(params, {"tokens": tokens.to(dev)})
        positions = torch.arange(SMALL_S, device=dev)[None].expand(SMALL_B, SMALL_S)
        h = model._run_decoder_stack(params, params["embed"][tokens.to(dev)].bfloat16(),
                                     positions=positions)
        greedy = model._head(params, h).argmax(dim=-1)  # every position's greedy token
        cache = {name: torch.from_numpy(a).to(dev, torch.bfloat16) for name, a in cache_np.items()}
        step_logits, _ = make_serve_step(model)(params, cache, {"token": tokens[:, cur].to(dev),
                                                                "cur_len": cur})
        seen[where] = (last.cpu(), greedy.cpu(), step_logits.cpu())
        del model, params, h, cache
    for label, i in (("prefill last-position logits", 0), ("decode-step logits", 2)):
        a, b = seen["cuda"][i], seen["cpu"][i]
        err = float((a - b).abs().max())
        if not torch.isfinite(a).all() or not err <= SMALL_ATOL:
            raise AssertionError(f"card vs CPU {label}: max |diff| {err} > {SMALL_ATOL}")
        log(f"card vs CPU: {label} {tuple(a.shape)}: max |diff| {err:.3e} (tolerance "
            f"{SMALL_ATOL:.3e}, max |logit| {float(b.abs().max()):.3e}), greedy tokens agree "
            f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}")
    share = float((seen["cuda"][1] == seen["cpu"][1]).float().mean())
    if share < SMALL_ARGMAX_SHARE:
        raise AssertionError(f"card vs CPU: greedy tokens agree at {share} of positions "
                             f"< {SMALL_ARGMAX_SHARE}")
    log(f"card vs CPU: {cfg.name} full width, {SMALL_LAYERS} layers, {SMALL_B} x {SMALL_S} tokens: "
        f"greedy tokens agree at {share:.4f} of all positions (required {SMALL_ARGMAX_SHARE})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size-mib", type=int, default=512)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "chip_smoke")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    # the plain versions run their f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.paper_store import EMULAB  # fails outside a checkout
    from repro_torch.kernels.cdc_gearhash import ops as cdc
    from repro_torch.kernels.gf256_matmul import ops as gf

    t_start = time.perf_counter()
    args.out.mkdir(parents=True, exist_ok=True)
    # phase 1
    card = card_line()
    log(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind} x{count}")
    size = args.size_mib << 20
    log(f"config: EMULAB CoARESECF n={EMULAB.n_servers} k={EMULAB.n_servers - EMULAB.parity_m} "
        f"ec_opt indexed coding_backend=kernel device=cuda blocks min={MIN_BLOCK} "
        f"avg={AVG_BLOCK} max={MAX_BLOCK} file={size} bytes seed={args.seed}; "
        f"cuts: {'none' if args.size_mib >= 512 else f'file {args.size_mib} MiB of 512'}")
    # phase 2
    build(args.out)
    # phase 3
    rng = np.random.default_rng(args.seed)
    data = rng.integers(0, 256, size, dtype=np.uint8)
    chunks = cdc.split_chunks(data.tobytes(), min_size=MIN_BLOCK, avg_size=AVG_BLOCK,
                              max_size=MAX_BLOCK, device="cuda")
    k = EMULAB.n_servers - EMULAB.parity_m
    path_L = sum((len(c) + k - 1) // k for c in chunks)  # width of the file's one encode
    kernels = [check_gf256(path_L, rng, card), check_gearhash(data, rng, card),
               check_flash(rng, card)]
    torch.cuda.empty_cache()
    # phase 4: the storage path, counted from zero
    payload = data.tobytes()
    del data, chunks
    torch.cuda.reset_peak_memory_stats()
    cdc.launches = 0
    gf.launches = 0
    t0 = time.perf_counter()
    seen = drive_path(payload, device="cuda", seed=args.seed, card=card)
    path_s = time.perf_counter() - t0
    counts = {"gf256_matmul": gf.launches, "cdc_gearhash": cdc.launches}
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"the main path never launched {name}")
    log(f"path: {path_s:.3f} s wall for the whole sequence, launches {counts}, "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes ({card})")
    profile_path(payload, args.out, args.seed)
    del payload
    # the same sequence on a small file: card vs plain versions on the CPU
    small_rng = np.random.default_rng(args.seed + 1)
    small = small_rng.integers(0, 256, SMALL_FILE, dtype=np.uint8).tobytes()
    on_card = drive_path(small, device="cuda", seed=args.seed, quiet=True)
    on_cpu = drive_path(small, device="cpu", seed=args.seed, quiet=True)
    for key in ("write", "reads", "edit", "margins", "moved", "fingerprint"):
        if on_card[key] != on_cpu[key]:
            raise AssertionError(f"small-file {key} differs between the card and the CPU: "
                                 f"{on_card[key]!r} != {on_cpu[key]!r}")
    log(f"path: {SMALL_FILE}-byte file gives the same stats and trace on the card as on the CPU")
    torch.cuda.empty_cache()
    # phase 5: the model path, counted from zero inside drive_model
    counts["flash_attention"] = drive_model(args.seed, card, args.out)
    torch.cuda.empty_cache()
    card_vs_cpu(args.seed)

    for entry in kernels:
        entry["launches"] = counts[entry["name"]]
    log(f"total: {time.perf_counter() - t_start:.3f} s ({card})")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: e[key] for key in order} for e in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
