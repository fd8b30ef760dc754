"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``, and the one definition of the flash call's work
(``kernels/flash_attention/work.py``).

- ``roofline_report`` gives the reference's dict for the same seeded
  inputs under ``V5E``; ``H100`` holds the datasheet's figures.
- ``roofline_table`` and ``pick_hillclimb`` print what the reference's print
  for the same seeded rows; ``dryrun_table`` differs only in its time
  column (the port's trace seconds for the reference's lower + compile).
- The flash operator's flop formula, counted by ``FlopCounterMode`` on fake
  tensors, is 4 B H hd times the unmasked pairs counted one query at a time
  over seeded shapes, windows and offsets; ``op_count`` charges a flash call
  ``work.hbm_bytes``, the bytes ``chip_smoke.py`` bounds its time by; and the
  bounds of ``PERF.md``'s kernel table keep their values.
"""
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import repro.roofline.analysis as ref_analysis
import repro.roofline.report as ref_report
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import work
from repro_torch.roofline import H100, V5E, roofline_report
from repro_torch.roofline import report
from repro_torch.roofline.op_count import count_step

BF16_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12  # chip_smoke.py's H100 figures


def _pairs(Sq: int, Sk: int, window: int, causal: bool, q_offset: int) -> int:
    """The unmasked pairs one query at a time (the loop ``chip_smoke.py``
    counted them with before ``work.causal_pairs``)."""
    if not causal and not window:
        return Sq * Sk
    last = (lambda q: min(q, Sk - 1)) if causal else (lambda q: Sk - 1)
    return sum(max(0, last(q) - (max(0, q - window + 1) if window else 0) + 1)
               for q in range(q_offset, q_offset + Sq))


@pytest.mark.parametrize("seed", range(8))
def test_roofline_report_is_the_references(seed):
    rng = np.random.default_rng(seed)
    kw = dict(flops=float(rng.uniform(1e9, 1e16)), bytes_accessed=float(rng.uniform(1e6, 1e13)),
              collective_bytes=float(rng.choice([0.0, rng.uniform(1e3, 1e12)])),
              n_chips=int(rng.choice([1, 256, 512])), model_flops=float(rng.uniform(1e9, 1e18)))
    links = int(rng.integers(1, 20))
    assert roofline_report(**kw) == ref_analysis.roofline_report(**kw)
    assert roofline_report(**kw, links_per_chip=links) == \
        ref_analysis.roofline_report(**kw, links_per_chip=links)
    assert (V5E.peak_flops, V5E.hbm_bw, V5E.link_bw, V5E.hbm_bytes) == \
        (ref_analysis.V5E.peak_flops, ref_analysis.V5E.hbm_bw, ref_analysis.V5E.link_bw,
         ref_analysis.V5E.hbm_bytes)


def test_h100_is_the_datasheets_card():
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert H100.link_bw * H100.links == 900e9  # NVLink 4: 18 links, 25 GB/s each way
    r = roofline_report(flops=989e12, bytes_accessed=0.0, collective_bytes=900e9, n_chips=1,
                        model_flops=0.0, hw=H100, links_per_chip=H100.links)
    assert r["compute"] == 1.0 and r["collective"] == 1.0


def _rows(seed: int, n: int = 24) -> list[dict]:
    """Seeded cells in the dry run's JSON form, with the reference's time
    keys and the port's."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        mesh = ("pod1", "pod2")[i % 2]
        status = rng.choice(["ok", "ok", "ok", "skipped", "error"])
        cell = f"arch{i // 4}__{('train_4k', 'prefill_32k', 'decode_32k')[i % 3]}__{mesh}"
        d = {"_cell": cell, "status": str(status)}
        if status == "error":
            d["error"] = f"RuntimeError: seeded {i}" * 3
        if status == "ok":
            terms = {k: float(rng.uniform(1e-6, 5.0)) for k in ("compute", "memory",
                                                                "collective")}
            dom = max(terms, key=terms.get)
            d.update(mesh=("16x16", "2x16x16")[i % 2], n_chips=(256, 512)[i % 2],
                     lower_s=float(rng.uniform(0, 100)), compile_s=float(rng.uniform(0, 100)),
                     per_chip_live_bytes=int(rng.integers(1, 2e11)),
                     fits_hbm=bool(rng.random() < .7),
                     flops_per_chip=float(rng.uniform(1e9, 1e16)),
                     collective_bytes_total=float(rng.uniform(0, 1e12)),
                     n_active_params=int(rng.integers(1, 3e10)),
                     roofline={**terms, "dominant": dom, "step_time_lower_bound": terms[dom],
                               "mfu_upper_bound": float(rng.uniform(0, 1)),
                               "model_flops_ratio": float(rng.uniform(0, 2))})
            d["trace_s"] = d["lower_s"] + d["compile_s"]
        rows.append(d)
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_report_tables_are_the_references(seed):
    rows = _rows(seed)
    for mesh in ("pod1", "pod2"):
        assert report.roofline_table(rows, mesh) == ref_report.roofline_table(rows, mesh)
    assert report.pick_hillclimb(rows) == ref_report.pick_hillclimb(rows)
    want = ref_report.dryrun_table(rows).replace("| lower+compile (s) |", "| trace (s) |")
    assert report.dryrun_table(rows) == want
    for x in (0.0, 3e-7, 4.2e-4, 0.37, 12.5):
        assert report.fmt_s(x) == ref_report.fmt_s(x)


def test_report_loads_the_dry_runs_files(tmp_path):
    rows = _rows(7)
    for d in rows:
        (tmp_path / f"{d['_cell']}.json").write_text(json.dumps(
            {k: v for k, v in d.items() if k != "_cell"}))
    got = report.load(str(tmp_path))
    assert [d["_cell"] for d in got] == sorted(d["_cell"] for d in rows)
    assert report.roofline_table(got) == ref_report.roofline_table(ref_report.load(str(tmp_path)))


@pytest.mark.parametrize("seed", range(6))
def test_flash_flop_formula_counts_the_unmasked_pairs(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        B, Hkv = int(rng.integers(1, 4)), int(rng.integers(1, 3))
        H, hd = Hkv * int(rng.integers(1, 4)), int(rng.choice(fa.HEAD_DIMS))
        Sk = int(rng.integers(1, 300))
        Sq = int(rng.integers(1, Sk + 1))
        causal = bool(rng.random() < 0.7)
        window = int(rng.choice([0, 0, 1, 7, 64, 500]))
        q_offset = int(rng.integers(0, Sk - Sq + 1)) if causal or window else 0
        want = 4 * B * H * hd * _pairs(Sq, Sk, window, causal, q_offset)
        assert work.causal_pairs(Sq, Sk, window, causal, q_offset) == \
            _pairs(Sq, Sk, window, causal, q_offset)
        with FakeTensorMode():
            q = torch.empty((B, H, Sq, hd), dtype=torch.bfloat16)
            k = torch.empty((B, Hkv, Sk, hd), dtype=torch.bfloat16)
            with FlopCounterMode(display=False) as flops:
                fa.flash_attention(q, k, k, causal=causal, window=window, q_offset=q_offset)
            assert flops.get_total_flops() == want
            _, c = count_step(lambda a, b: fa.flash_attention(
                a, b, b, causal=causal, window=window, q_offset=q_offset), q, k)
        assert c.flops == want and c.flash_calls == 1
        assert c.hbm_bytes == work.hbm_bytes(B, H, Hkv, Sq, Sk, hd, 2, window, causal, q_offset)
        assert c.hbm_bytes == (2 * B * H * Sq * hd + 2 * B * Hkv * hd * work.keys_reached(
            Sq, Sk, window, causal, q_offset)) * 2


# PERF.md's kernel table, flash's bounds (ms, as printed there): (B, H, Hkv,
# Sq, Sk, hd, causal, window, q_offset) -> bound
PERF_BOUNDS = {
    **{(1, 14, 2, 4096, 32768, 64, True, 0, off): ms for off, ms in zip(
        range(0, 32768, 4096), (0.0304, 0.0912, 0.1520, 0.2128, 0.2736, 0.3344, 0.3952, 0.4560))},
    (1, 4, 1, 2048, 32768, 256, True, 512, 0): 0.0038,
    (1, 4, 1, 2048, 32768, 256, True, 512, 16384): 0.0043,
    (1, 4, 1, 2048, 32768, 256, True, 512, 30720): 0.0043,
    (1, 4, 1, 2048, 32768, 256, True, 0, 0): 0.0087,
    (1, 4, 1, 2048, 32768, 256, True, 0, 16384): 0.1477,
    (1, 4, 1, 2048, 32768, 256, True, 0, 30720): 0.2693,
    (1, 4, 1, 16384, 32768, 256, True, 512, 0): 0.0342,
    (1, 4, 1, 16384, 32768, 256, True, 512, 16384): 0.0347,
    (1, 4, 1, 16384, 32768, 256, True, 0, 0): 0.5559,
    (1, 4, 1, 16384, 32768, 256, True, 0, 16384): 1.6676,
    (4, 14, 2, 512, 2048, 64, True, 0, 0): 0.0025,
    (4, 14, 2, 512, 2048, 64, True, 0, 512): 0.0057,
    (4, 14, 2, 512, 2048, 64, True, 0, 1024): 0.0095,
    (4, 14, 2, 512, 2048, 64, True, 0, 1536): 0.0133,
    (4, 14, 2, 2048, 2048, 64, True, 0, 0): 0.0304,
    (4, 16, 16, 2048, 2048, 128, True, 0, 0): 0.0695,
    (4, 32, 32, 2048, 2048, 112, True, 0, 0): 0.1217,
    (4, 4, 1, 2048, 2048, 256, True, 512, 0): 0.0152,
    (4, 4, 1, 2048, 2048, 256, True, 0, 0): 0.0348,
    (4, 8, 8, 1500, 1500, 64, False, 0, 0): 0.0186,
    (4, 8, 8, 448, 448, 64, True, 0, 0): 0.0022,
    (4, 8, 8, 448, 1500, 64, False, 0, 0): 0.0056,
    (4, 28, 4, 2048, 2048, 128, True, 0, 0): 0.1217,
}


@pytest.mark.parametrize("case", sorted(PERF_BOUNDS), ids=str)
def test_perf_md_flash_bounds_keep_their_values(case):
    B, H, Hkv, Sq, Sk, hd, causal, window, off = case
    flop_ms = work.flops(B, H, Sq, Sk, hd, window, causal, off) / BF16_FLOPS * 1e3
    byte_ms = work.hbm_bytes(B, H, Hkv, Sq, Sk, hd, 2, window, causal, off) / HBM_BYTES_PER_S * 1e3
    assert round(max(flop_ms, byte_ms), 4) == PERF_BOUNDS[case]
