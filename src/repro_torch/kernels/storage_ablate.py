"""Ablation builds of the two storage kernels, timed side by side on the card.

Each variant is ``csrc/gf256_matmul.cu`` or ``csrc/cdc_gearhash.cu`` with
one text edit, built by ``nvcc`` into its own library under
``build/kernels/ablate/`` (all builds at once), and timed in turns (each
variant, then all again in reverse order) at the storage path's shapes: the
(5, 6) encode and (6, 6) decode of 89478724 columns, and a 512 MiB stream.

- ``units only``: every nonzero coefficient is taken as 1, so no bit planes
  and no LOP3 products: the time of the loads, the realignment and the
  stores alone. Its result is wrong; its time says what the products cost.
- ``2 blocks an SM``: the GF kernel's launch bound of 3 blocks an SM set to 2.
- ``hashes stored from registers``: each lane stores its 16 hashes as four
  16-byte words 64 bytes apart, without the shared-memory transpose.

    python -m repro_torch.kernels.storage_ablate
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.erasure.rs import _decoder_cached, _parity_cached
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ablate import cuda_ms

PATH_L = 89478724  # the columns of the 512 MiB file's one encode
STREAM = 512 << 20
MASK = (1 << 19) - 1  # the path's boundary mask (512 KiB average blocks)

UNIT_ROWS = ("    if (!t.planes[r]) {  // only coefficients 0 and 1 in this input row",
             "    if (true) {")
UNIT_XOR = ("if (t.splat[i][r][0] == kUnit) acc[i] = xor4(acc[i], x);",
            "if (t.splat[i][r][0] != 0u) acc[i] = xor4(acc[i], x);")
BOUND = ("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")
HASH_BEGIN = "    if (kHash) {\n      // through shared memory"
HASH_END = "      __syncwarp();  // read before the next step writes\n    }\n"
HASH_DIRECT = """    if (kHash) {
      if (p + kPerLane <= L) {
        uint4* out = reinterpret_cast<uint4*>(hash + p);
        for (int q = 0; q < 4; ++q) {
          out[q] = make_uint4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        }
      } else {
        for (int j = 0; j < kPerLane; ++j) if (p + j < L) hash[p + j] = h[j];
      }
    }
"""


def _edit(src: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"storage_ablate: the kernel source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def gf_variants(src: str) -> dict[str, str]:
    return {"kernel": src, "units only": _edit(src, UNIT_ROWS, UNIT_XOR),
            "2 blocks an SM": _edit(src, BOUND)}


def gear_variants(src: str) -> dict[str, str]:
    begin = src.find(HASH_BEGIN)
    end = src.find(HASH_END)
    if begin < 0 or end < 0:
        raise RuntimeError("storage_ablate: the gear-hash source no longer holds its hash store")
    return {"kernel": src,
            "hashes stored from registers": src[:begin] + HASH_DIRECT + src[end + len(HASH_END):]}


def main() -> int:
    if not torch.cuda.is_available():
        print("storage_ablate: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gf = _build.build_variants("gf256_matmul",
                               gf_variants((_build.CSRC / "gf256_matmul.cu").read_text()))
    gear = _build.build_variants("cdc_gearhash",
                                 gear_variants((_build.CSRC / "cdc_gearhash.cu").read_text()))
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    B = torch.from_numpy(rng.integers(0, 256, (6, PATH_L), dtype=np.uint8)).cuda()
    matrices = (("encode", _parity_cached(11, 6)),
                ("decode", _decoder_cached(11, 6, (1, 2, 3, 4, 5, 6))))
    for label, A in matrices:
        A = np.ascontiguousarray(A)
        out = torch.empty((A.shape[0], PATH_L), dtype=torch.uint8, device="cuda")
        runs = {}
        for name, lib in gf.items():
            fn = lib.gf256_matmul_launch
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
            args = (A.ctypes.data, B.data_ptr(), out.data_ptr(), A.shape[0], 6, PATH_L, stream)
            runs[name] = (lambda fn=fn, args=args: _build.check(fn(*args), "ablate"))
        for name in list(runs) + list(runs)[::-1]:
            print(f"ablate: gf256_matmul {label} {A.shape} x (6, {PATH_L}) {name}: "
                  f"{cuda_ms(runs[name], 20):.4f} ms ({card})", flush=True)
        del out
    del B
    x = torch.from_numpy(rng.integers(0, 256, STREAM, dtype=np.uint8)).cuda()
    h = torch.empty(STREAM, dtype=torch.uint32, device="cuda")
    b = torch.empty(STREAM, dtype=torch.uint8, device="cuda")
    runs = {}
    for name, lib in gear.items():
        fn = lib.gearhash_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p]
        runs[f"{name}, hash + bitmap"] = (lambda fn=fn: _build.check(
            fn(x.data_ptr(), h.data_ptr(), b.data_ptr(), STREAM, MASK, stream), "ablate"))
    runs["kernel, bitmap only"] = (lambda fn=gear["kernel"].gearhash_launch: _build.check(
        fn(x.data_ptr(), None, b.data_ptr(), STREAM, MASK, stream), "ablate"))
    for name in list(runs) + list(runs)[::-1]:
        print(f"ablate: gearhash L={STREAM} {name}: {cuda_ms(runs[name], 20):.4f} ms ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
