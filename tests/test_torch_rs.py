"""repro_torch's RSCode against repro's RSCode(backend="numpy").

The port's code runs on the CPU (``device="cpu"``) on all three backends:
"numpy" (the byte LUT), "kernel" (the plain PyTorch version of the GF(256)
kernel) and "auto". Every result must equal the reference byte for byte:
fragments, CRCs, decoded bytes, rebuilt fragments and the code's matrices.
"""
import numpy as np
import pytest
import torch

from repro.erasure import rs as ref_rs

from repro_torch.erasure import rs as port_rs
from repro_torch.kernels.gf256_matmul import ops as port_gf

BACKENDS = ("numpy", "kernel", "auto")


def _values(seed, count, max_len):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, int(rng.integers(0, max_len)), dtype=np.uint8).tobytes()
           for _ in range(count)]
    out.append(b"")  # empty value
    return out


def _codes(n, k, backend):
    return (ref_rs.RSCode(n=n, k=k, backend="numpy"),
            port_rs.RSCode(n=n, k=k, backend=backend, device="cpu"))


@pytest.mark.parametrize("n,k", [(11, 6), (8, 6), (14, 10), (5, 5), (3, 1)])
def test_parity_and_decoder_matrices(n, k):
    np.testing.assert_array_equal(port_rs._parity_cached(n, k), ref_rs._parity_cached(n, k))
    rng = np.random.default_rng(n * 31 + k)
    for _ in range(4):
        idxs = tuple(sorted(rng.permutation(n)[:k].tolist()))
        np.testing.assert_array_equal(port_rs._decoder_cached(n, k, idxs),
                                      ref_rs._decoder_cached(n, k, idxs))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,k,L", [(11, 6, 4099), (8, 6, 64), (14, 10, 2048), (4, 4, 100)])
def test_encode_decode(backend, n, k, L):
    ref, port = _codes(n, k, backend)
    rng = np.random.default_rng(L)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    coded = port.encode(data)
    np.testing.assert_array_equal(coded, ref.encode(data))
    for _ in range(3):
        keep = rng.permutation(n)[:k].tolist()
        np.testing.assert_array_equal(port.decode(coded[keep], keep), data)
        np.testing.assert_array_equal(port.decode(coded[keep], keep), ref.decode(coded[keep], keep))
    B = 3
    blocks = rng.integers(0, 256, (B, k, 33), dtype=np.uint8)
    np.testing.assert_array_equal(port.encode_batch(blocks), ref.encode_batch(blocks))
    keep = list(range(n - k, n))
    enc = ref.encode_batch(blocks)[:, keep, :]
    np.testing.assert_array_equal(port.decode_batch(enc, keep), blocks)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,k", [(11, 6), (6, 4), (3, 3)])
def test_bytes_batch_paths(backend, n, k):
    """Ragged and empty values, m == 0, mixed index subsets, the systematic
    fast path, and CRCs — byte-identical to the reference."""
    ref, port = _codes(n, k, backend)
    values = _values(n * 100 + k, 6, 70_000)
    for with_crc in (False, True):
        assert port.encode_bytes_batch(values, with_crc=with_crc) == \
            ref.encode_bytes_batch(values, with_crc=with_crc)
    enc = ref.encode_bytes_batch(values, with_crc=True)
    rng = np.random.default_rng(k)
    items = []
    for j, (frags, orig, crcs) in enumerate(enc):
        if j % 3 == 0:
            idxs = list(range(min(n, k + 1)))          # systematic (+1 spare)
        else:
            idxs = sorted(rng.permutation(n)[:k].tolist())  # mixed data + parity
        items.append(({i: frags[i] for i in idxs}, orig, {i: crcs[i] for i in idxs}))
    assert port.decode_bytes_batch(items) == values
    assert port.decode_bytes_batch(items) == ref.decode_bytes_batch(items)
    assert port.decode_bytes(*items[1]) == values[1]


@pytest.mark.parametrize("fuse", [None, True, False])
def test_group_fusion_choice_gives_the_same_bytes(fuse):
    ref = ref_rs.RSCode(n=11, k=6, backend="numpy")
    port = port_rs.RSCode(n=11, k=6, backend="kernel", fuse_groups=fuse, device="cpu")
    values = _values(3, 5, 20_000)
    enc = ref.encode_bytes_batch(values)
    subsets = [[0, 1, 2, 3, 4, 6], [1, 2, 3, 4, 5, 7], [5, 6, 7, 8, 9, 10]]
    items = [({i: f[i] for i in subsets[j % 3]}, o) for j, (f, o) in enumerate(enc)]
    assert port.decode_bytes_batch(items) == values


def test_crc_drop_and_truncation_raise_valueerror():
    for backend in BACKENDS:
        ref, port = _codes(6, 4, backend)
        [(frags, orig, crcs)] = ref.encode_bytes_batch([b"x" * 1000], with_crc=True)
        bad = dict(enumerate(frags))
        bad[4] = bytes([bad[4][0] ^ 1]) + bad[4][1:]
        sub = {i: bad[i] for i in (1, 2, 3, 4)}
        with pytest.raises(ValueError):
            port.decode_bytes_batch([(sub, orig, {i: crcs[i] for i in sub})])
        short = {i: frags[i] for i in (0, 1, 2, 5)}
        short[5] = short[5][:-1]
        with pytest.raises(ValueError):
            port.decode_bytes_batch([(short, orig)])
        tiny = {i: frags[i][:10] for i in range(4)}
        with pytest.raises(ValueError):
            port.decode_bytes_batch([(tiny, orig)])
        assert port_rs.element_crc_ok((frags[0], orig, crcs[0]))
        assert not port_rs.element_crc_ok((frags[0], orig, crcs[0] ^ 1))
        assert port_rs.element_crc_ok((frags[0], orig)) == ref_rs.element_crc_ok((frags[0], orig))


@pytest.mark.parametrize("backend", BACKENDS)
def test_reconstruct_fragments(backend):
    ref, port = _codes(11, 6, backend)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (6, 5000), dtype=np.uint8)
    coded = ref.encode(data)
    keep = [1, 2, 4, 6, 8, 10]
    for targets in ([0], [0, 3, 5], [7, 9], []):
        got = port.reconstruct_fragments(targets, coded[keep], keep)
        np.testing.assert_array_equal(got, ref.reconstruct_fragments(targets, coded[keep], keep))
    np.testing.assert_array_equal(port.reconstruct_fragment(9, coded[keep], keep), coded[9])


def test_validation_and_device():
    with pytest.raises(ValueError):
        port_rs.RSCode(n=4, k=5, device="cpu")
    with pytest.raises(ValueError):
        port_rs.RSCode(n=6, k=4, backend="pallas", device="cpu")
    assert port_rs.BACKENDS == ref_rs.BACKENDS
    assert port_rs.AUTO_KERNEL_MIN_BYTES == ref_rs.AUTO_KERNEL_MIN_BYTES
    assert port_gf.kernel_is_native() is False


def test_cuda_code_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_rs.RSCode(n=6, k=4, backend="kernel", device="cuda")
