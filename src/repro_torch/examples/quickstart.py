"""Quickstart: the paper's system in 60 lines — Session/future API.

Spins up a CoARESF deployment (fragmented + erasure-coded + reconfigurable),
writes a batch of large objects in ONE coalesced fan-out, reads them back,
inspects reliability margins, survives server crashes, and live-reconfigures
to a new server set — all on the deterministic virtual-time network. The
data plane (the RS code's GF(256) products and the CDC chunker's gear hash)
runs on ``--device`` (the card by default; its plain PyTorch versions with
``--device cpu``); the control plane, and so every printed line, is the
same on both.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import DSS, DSSParams, gather


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # --- deploy: 8 servers, [n=8, k=6] Reed-Solomon, EC-DAPopt, fragmented -----
    dss = DSS(DSSParams(algorithm="coaresecf", n_servers=8, parity_m=2, seed=0,
                        min_block=4096, avg_block=16384, max_block=65536,
                        indexed=True, device=args.device))
    alice = dss.session("alice")
    bob = dss.session("bob")
    print(f"deployed CoARESECF: n={dss.c0.n} k={dss.c0.k} "
          f"quorum={dss.c0.quorum()} tolerates {(dss.c0.n-dss.c0.k)//2} crashes")

    # --- write three 1 MB files in ONE coalesced fan-out -------------------------
    rng = np.random.default_rng(0)
    docs = {f"report{i}.bin": rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
            for i in range(3)}
    futs = [alice.write(fid, doc) for fid, doc in docs.items()]
    stats = gather(*futs)                       # drive the net; results in order
    st = futs[0].stats                          # uniform OpStats on every future
    print(f"write: {sum(s['blocks'] for s in stats)} CDC blocks across "
          f"{len(docs)} files in {st.rounds} quorum rounds total "
          f"(coalesced x{st.batched_with}; {st.bytes/1e6:.1f} MB on the wire)")

    # --- read them back ----------------------------------------------------------
    reads = [bob.read(fid) for fid in docs]
    assert gather(*reads) == list(docs.values())
    print(f"read: OK ({len(docs)} MiB-files, decoded from k-of-n fragments, "
          f"{reads[0].stats.rounds} quorum rounds for the whole fan-out)")

    # --- incremental edit: only touched blocks rewrite ---------------------------
    edit = bytearray(docs["report0.bin"])
    edit[500_000:500_016] = b"EDITED-IN-PLACE!"
    st2 = alice.write("report0.bin", bytes(edit)).result()
    print(f"edit: rewrote {st2['written']}/{st2['blocks']} blocks "
          f"(rsync-style CDC — the paper's Fig.4 flat-write-latency effect)")

    # --- reliability margin, before and after a crash ----------------------------
    print(f"stat: margin={alice.stat('report0.bin').result()['margin']} "
          f"(fragment losses the weakest block still survives)")
    dss.crash_servers(["s7"])
    assert bob.read("report0.bin").result() == bytes(edit)
    print(f"crash: s7 down, read still OK (EC quorum), "
          f"margin now {alice.stat('report0.bin').result()['margin']}")

    # --- live reconfiguration to a fresh server set + ABD DAP --------------------
    admin = dss.session("admin")
    new_cfg = dss.make_config(dap="abd", n_servers=5, fresh_servers=True)
    nblocks = admin.recon("report0.bin", new_cfg).result()["blocks"]
    print(f"recon: migrated {nblocks} blocks to 5 fresh servers under ABD "
          f"(service stayed readable throughout)")
    assert bob.read("report0.bin").result() == bytes(edit)
    print("read after recon: OK — done.")


if __name__ == "__main__":
    main()
