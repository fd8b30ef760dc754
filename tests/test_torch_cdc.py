"""repro_torch's gear-hash CDC against repro's Pallas kernel and oracle.

On the CPU the port's ``gearhash`` runs its plain PyTorch version (int64
arithmetic masked to 32 bits); the reference runs its Pallas kernel in
interpret mode and its pure-jnp oracle. Hashes, bitmaps and chunk lists
must be identical: the tolerance is 0.
"""
import numpy as np
import pytest
import torch

from repro.kernels.cdc_gearhash.ops import gearhash as ref_gearhash
from repro.kernels.cdc_gearhash.ops import split_chunks as ref_split_chunks
from repro.kernels.cdc_gearhash.ref import gearhash_ref as jnp_ref

from repro_torch.kernels.cdc_gearhash import ops as port_ops


def _port_hash(data, mask=0xFFFF):
    h, b = port_ops.gearhash(data, mask=mask, device="cpu")
    return h.numpy(), b.numpy()


@pytest.mark.parametrize("L", [1, 31, 32, 33, 128, 4096, 5000, 12288])
@pytest.mark.parametrize("mask", [0xFF, 0xFFF])
def test_port_matches_pallas_interpret(L, mask):
    rng = np.random.default_rng(L + mask)
    data = rng.integers(0, 256, L, dtype=np.uint8)
    h_k, b_k = ref_gearhash(data, mask=mask, block_l=1024, interpret=True)
    h_p, b_p = _port_hash(data, mask)
    assert h_p.dtype == np.uint32 and b_p.dtype == np.uint8
    np.testing.assert_array_equal(h_p, np.asarray(h_k))
    np.testing.assert_array_equal(b_p, np.asarray(b_k))


@pytest.mark.parametrize("mask", [0, 0xFFFF, 0xFFFFFFFF])
def test_port_matches_jnp_oracle(mask):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 20_000, dtype=np.uint8)
    data[5000:9000] = 0  # long zero runs: gear(0) != 0 inside the window too
    h_r, b_r = jnp_ref(jnp.asarray(data), mask=mask)
    h_p, b_p = _port_hash(data, mask)
    np.testing.assert_array_equal(h_p, np.asarray(h_r))
    np.testing.assert_array_equal(b_p, np.asarray(b_r))


def test_leading_zero_bytes_hash_gear_of_zero():
    """Positions before 0 are zero bytes, not zero hashes: an all-zero
    stream hashes like the tail of a longer all-zero stream."""
    h_short, _ = _port_hash(np.zeros(40, dtype=np.uint8))
    h_long, _ = _port_hash(np.zeros(80, dtype=np.uint8))
    np.testing.assert_array_equal(h_short, h_long[:40])
    assert len(set(h_long[31:].tolist())) == 1 and h_long[31] != 0


def test_locality_of_hash():
    """Hash at position i depends only on bytes (i-31..i)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 2048, dtype=np.uint8)
    b = a.copy()
    b[100] ^= 0xFF
    ha, _ = _port_hash(a)
    hb, _ = _port_hash(b)
    diff = np.nonzero(ha != hb)[0]
    assert diff.min() >= 100 and diff.max() <= 100 + 31


@pytest.mark.parametrize("sizes", [(64, 128, 512), (512, 1024, 4096), (4096, 16384, 65536)])
def test_split_chunks_matches_reference(sizes):
    mins, avgs, maxs = sizes
    rng = np.random.default_rng(mins)
    blob = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    kw = dict(min_size=mins, avg_size=avgs, max_size=maxs)
    got = port_ops.split_chunks(blob, device="cpu", **kw)
    assert got == ref_split_chunks(blob, **kw)
    assert b"".join(got) == blob


@pytest.mark.parametrize("seed", range(6))
def test_split_chunks_partition_random(seed):
    rng = np.random.default_rng(100 + seed)
    blob = rng.integers(0, 256, int(rng.integers(1, 8192)), dtype=np.uint8).tobytes()
    sz = seed % 4
    kw = dict(min_size=[64, 128, 256, 512][sz], avg_size=[128, 256, 512, 1024][sz],
              max_size=[512, 1024, 2048, 4096][sz])
    got = port_ops.split_chunks(blob, device="cpu", **kw)
    assert got == ref_split_chunks(blob, interpret=True, **kw)
    assert b"".join(got) == blob
    assert all(len(c) <= kw["max_size"] for c in got)


def test_boundary_bitmap_and_mask():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    bm = port_ops.boundary_bitmap(data, avg_size=1024, device="cpu")
    from repro.kernels.cdc_gearhash.ops import _mask_for_avg, boundary_bitmap

    np.testing.assert_array_equal(bm, boundary_bitmap(data, avg_size=1024))
    for avg in (1, 2, 3, 1000, 1024, 1 << 19, (1 << 19) + 1):
        assert port_ops._mask_for_avg(avg) == _mask_for_avg(avg)


def test_empty_and_tiny_inputs():
    kw = dict(min_size=4, avg_size=8, max_size=16, device="cpu")
    assert port_ops.split_chunks(b"", **kw) == [b""]
    assert port_ops.split_chunks(b"abc", **kw) == ref_split_chunks(b"abc", min_size=4, avg_size=8,
                                                                   max_size=16)
    h, b = port_ops.gearhash(b"", device="cpu")
    assert h.shape == (0,) and b.shape == (0,)


def test_cpu_calls_do_not_count_launches_and_bad_input_raises():
    before = port_ops.launches
    port_ops.split_chunks(bytes(range(256)) * 8, min_size=64, avg_size=128, max_size=512,
                          device="cpu")
    assert port_ops.launches == before
    with pytest.raises(ValueError):
        port_ops.gearhash(b"abc", mask=1 << 32, device="cpu")
    with pytest.raises(ValueError):
        port_ops.gearhash(torch.zeros(4, dtype=torch.int32))


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_ops.split_chunks(b"x" * 100, min_size=4, avg_size=8, max_size=16, device="cuda")
