"""The paper's §VII-E headline scenario (Fig. 10), on the Session API: the
storage service keeps serving concurrent readers/writers while a
reconfigurer switches both the DAP (ABD <-> EC) and the server set, five
times. Scripted client loops ride ``Session.submit``; one-shot operations
use the write/read/recon futures. The data plane runs on ``--device`` (the
card by default); the printed line is the same on the CPU.

  PYTHONPATH=src python -m repro_torch.examples.reconfigure_live [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import DSS, DSSParams, Workload


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dss = DSS(DSSParams(algorithm="coaresecf", n_servers=11, parity_m=5, seed=42,
                        min_block=2048, avg_block=8192, max_block=32768,
                        indexed=True, device=args.device))
    rng = np.random.default_rng(1)
    doc = rng.integers(0, 256, 256 * 1024, dtype=np.uint8).tobytes()
    dss.session("boot").write("shared.bin", doc).result()

    wl = Workload(dss)

    for wi in range(3):
        def wloop(s=wl.session(f"w{wi}"), wi=wi):
            # a scripted read-modify-write loop: drives the legacy generator
            # ops of s.handle, submitted as ONE session op with OpStats.
            n_ok = 0
            for r in range(4):
                cur = yield from s.handle.read("shared.bin")
                buf = bytearray(cur)
                pos = (wi * 50_021 + r * 13_337) % max(1, len(buf))
                buf[pos] ^= 0xFF
                st = yield from s.handle.update("shared.bin", bytes(buf))
                n_ok += st["success"]
            return n_ok
        wl.submit(f"w{wi}", wloop(), kind="writer-loop")

    for ri in range(3):
        def rloop(s=wl.session(f"r{ri}")):
            sizes = []
            for _ in range(5):
                c = yield from s.handle.read("shared.bin")
                sizes.append(len(c))
            return sizes
        wl.submit(f"r{ri}", rloop(), kind="reader-loop")

    def gloop(s=wl.session("admin")):
        plans = [("abd", 7), ("ec_opt", 11), ("abd", 5), ("ec_opt", 9), ("ec_opt", 11)]
        for dap, n in plans:
            cfg = dss.make_config(dap=dap, n_servers=n)
            yield from s.handle.recon("shared.bin", cfg)
        return len(plans)
    wl.submit("admin", gloop(), kind="recon-loop")

    results = wl.run()                # drives everything concurrently
    writes_ok = sum(results[:3])
    reads = sum(len(r) for r in results[3:6])
    recons = results[-1]
    admin_stats = wl.futures[-1].stats

    final = dss.session("final").read("shared.bin")
    print(f"service uninterrupted: {recons} recons (ABD<->EC, 5-11 servers, "
          f"{admin_stats.rounds} quorum rounds), {writes_ok}/12 writes prevailed, "
          f"{reads} reads OK, final file {len(final.result())>>10} KiB, "
          f"virtual time {dss.net.now*1e3:.0f} ms")


if __name__ == "__main__":
    main()
