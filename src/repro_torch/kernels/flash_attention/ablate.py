"""Ablation builds of the flash kernel, timed side by side on the card.

Each variant is ``csrc/flash_attention.cu`` with one text edit (no softmax,
no exp2, no products in the main loop, fewer warpgroups per CTA, narrower
key tiles), built by ``nvcc`` into its own library under
``build/kernels/ablate/flash_attention/`` (all builds at once), and timed
in turns (each variant, then all again in reverse order) on one bf16
input, beside ``scaled_dot_product_attention`` as a yardstick. A variant
without a part computes a wrong result: its time only says what that part
costs.

    python -m repro_torch.kernels.flash_attention.ablate [--shape B,H,Hkv,S,hd] [--non-causal]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build

LOOP_QK = "      issue_qk<HD, BK, BQ>(sc, q_wg, sk + s * KV_BYTES);\n"
LOOP_PV = "      issue_pv<NCH, BK>(acc, pa, sv + sp * KV_BYTES);\n"
SOFTMAX = "tile_softmax<BK>(sc, m, l, alpha, c, tile_is_masked(k0), k0, plo + r0, c0, Sk, causal,"
EXP2 = ("sc[i] = sm90::exp2_approx(fmaf(sc[i], c, -m[r]));", "sc[i] = fmaf(sc[i], c, -m[r]);")
NWG = ("static constexpr int NWG = HD <= 64 ? 3 : HD <= 128 ? 2 : 1;",
       "static constexpr int NWG = HD <= 128 ? 2 : 1;")
BK64 = ("case 64: return tc::launch<64, 128>", "case 64: return tc::launch<64, 64>")


def variants(src: str) -> dict[str, str]:
    def without_softmax(text: str) -> str:
        out = []
        for block in text.split(SOFTMAX):  # each call runs to the end of its statement
            out.append(block if not out else block.split(";", 1)[1])
        return "".join(out)

    for needle in (LOOP_QK, LOOP_PV, SOFTMAX, EXP2[0], NWG[0], BK64[0]):
        if needle not in src:
            raise RuntimeError(f"ablate: the kernel source no longer holds {needle!r}")
    return {
        "kernel": src,
        "no softmax": without_softmax(src),
        "no exp2": src.replace(*EXP2),
        "no products in the loop": src.replace(LOOP_QK, "").replace(LOOP_PV, ""),
        "2 warpgroups at hd <= 64": src.replace(*NWG),
        "key tiles of 64 at hd 64": src.replace(*BK64),
    }


def launcher(lib: ctypes.CDLL, q, k, v, causal: bool):
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    out = torch.empty_like(q)
    B, H, Sq, hd = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[1], Sq,
            k.shape[2], hd, 0, 1, int(causal), 0)

    def run():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "ablate")
    return run


def cuda_ms(fn, iters: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="4,14,2,2048,64", help="B,H,Hkv,S,hd (the prefill's)")
    ap.add_argument("--non-causal", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    B, H, Hkv, S, hd = (int(x) for x in args.shape.split(","))
    causal = not args.non_causal
    libs = _build.build_variants("flash_attention",
                                 variants((_build.CSRC / "flash_attention.cu").read_text()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).bfloat16()
               for shape in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
    pairs = (S * (S + 1) // 2 if causal else S * S) * B * H
    ke, ve = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    runs = {name: launcher(lib, q, k, v, causal) for name, lib in libs.items()}
    names = list(runs) + list(runs)[::-1]
    for name in ["scaled_dot_product_attention"] + names:
        fn = runs.get(name) or (lambda: sdpa(q, ke, ve, is_causal=causal))
        ms = cuda_ms(fn)
        print(f"ablate: q({B}, {H}, {S}, {hd}) k/v({B}, {Hkv}, {S}, {hd}) bf16 causal={causal} "
              f"{name}: {ms:.4f} ms, {4 * hd * pairs / ms / 1e9:.1f} TFLOP/s ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
