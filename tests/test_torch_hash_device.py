"""The port's device string hashing X2 (split + FarmHash Fingerprint64 +
bucket mod, over int64-carried u64 in its plain version) against the JAX
reference recom_tpu.ops.hash_device and the NumPy oracle, bit for bit: every
length branch (0..64 bytes), empty pieces and rows, bytes >= 0x80, bucket
counts up to 2^31.  The kernel's modulo (a multiply by per-column
reciprocals) is emulated in numpy uint64 against ``%``.  The CUDA kernel is
held against the plain version on a card, on the inputs where its staging,
warp split and piece list have edges."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from recom_tpu.ops import hash_device as jhd
from recom_tpu.oracle.hashing import farmhash64, hash_bucket_fast
from recom_tpu_torch.ops import hash_device as thd
from recom_tpu_torch.ops import kernels

torch.set_num_threads(1)

LENGTHS = [0, 1, 3, 4, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64]
BUCKETS_NEAR_2_31 = [(1 << 31) - 1, (1 << 31) - 5, 1 << 31]
M32 = np.uint64(0xFFFFFFFF)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _piece(rng, n, high=True):
    """n random non-NUL bytes; ``high`` draws from the whole 1..255 range
    (bytes >= 0x80 included), else printable ASCII."""
    lo, hi = (1, 256) if high else (97, 123)
    return bytes(rng.integers(lo, hi, n).astype(np.uint8))


def _pad_rows(rows, extra=8):
    w = max((len(r) for r in rows), default=1)
    wp = ((w + extra + 3) // 4) * 4
    out = np.zeros((len(rows), wp), np.uint8)
    for i, r in enumerate(rows):
        out[i, : len(r)] = np.frombuffer(r, np.uint8)
    return out


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


@pytest.mark.parametrize("high", [False, True])
def test_farmhash_pieces_every_length_branch(high):
    rng = np.random.default_rng(int(high))
    rows = [_piece(rng, n, high) for n in LENGTHS for _ in range(3)]
    b = _pad_rows(rows)
    ln = np.asarray([len(r) for r in rows], np.int32)[:, None]
    off = np.zeros_like(ln)
    got = _u64(thd.farmhash64_pieces(
        torch.from_numpy(b), torch.from_numpy(off), torch.from_numpy(ln)
    ))[:, 0]
    want = np.asarray([farmhash64(r) for r in rows], np.uint64)
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jhd.farmhash64_pieces(
        jnp.asarray(b), jnp.asarray(off), jnp.asarray(ln)
    ))[:, 0]
    np.testing.assert_array_equal(got, ref)


def test_mod_buckets_matches_uint64_remainder():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 1 << 64, 4000, dtype=np.uint64)
    h[:4] = [0, 1, (1 << 64) - 1, 1 << 63]
    for m in [1, 7, 10_000, 1 << 23] + BUCKETS_NEAR_2_31:
        got = thd.mod_buckets(
            torch.from_numpy(h.view(np.int64)), torch.tensor(m)
        ).numpy()
        np.testing.assert_array_equal(got, (h % np.uint64(m)).astype(np.int32))


def test_fixed_hash_ids_matches_reference_and_oracle():
    rng = np.random.default_rng(3)
    buckets = np.asarray([7, 100, 10_000] + BUCKETS_NEAR_2_31, np.int64)
    c, b = len(buckets), 40
    cols = [[_piece(rng, int(rng.choice(LENGTHS)), high=bool(i % 2))
             for _ in range(b)] for i in range(c)]
    w = max(len(r) for col in cols for r in col)
    wp = ((w + 8 + 3) // 4) * 4
    rows = np.zeros((c, b, wp), np.uint8)
    for i, col in enumerate(cols):
        for j, r in enumerate(col):
            rows[i, j, : len(r)] = np.frombuffer(r, np.uint8)
    got = thd.fixed_hash_ids(torch.from_numpy(rows),
                             torch.from_numpy(buckets)).numpy()
    ref = np.asarray(jhd.fixed_hash_ids(jnp.asarray(rows),
                                        jnp.asarray(buckets)))
    np.testing.assert_array_equal(got, ref)
    for i in range(c):
        np.testing.assert_array_equal(
            got[i], hash_bucket_fast(cols[i], int(buckets[i])), f"col {i}"
        )


def _split_case(seed, c, b, high):
    rng = np.random.default_rng(seed)
    delims = np.frombuffer(b";|,", np.uint8)[:c]
    cols = []
    for i in range(c):
        d = bytes([delims[i]])
        rows = []
        for _ in range(b):
            k = int(rng.integers(0, 9))           # up to 8 pieces, some > L
            pieces = [
                _piece(rng, int(rng.choice(LENGTHS)), high).replace(d, b"x")
                for _ in range(k)
            ]
            rows.append(d.join(pieces))
        rows[0] = b""                              # empty row: no pieces
        rows[1] = d * 3                            # four empty pieces
        rows[2] = d + _piece(rng, 5, high).replace(d, b"x")   # leading empty
        cols.append(rows)
    return delims, cols


@pytest.mark.parametrize("high", [False, True])
def test_split_hash_ids_matches_reference_and_oracle(high):
    c, b, L = 3, 30, 6
    delims, cols = _split_case(4 + high, c, b, high)
    buckets = np.asarray([101, 9_999, (1 << 31) - 1], np.int64)
    w = max(len(r) for col in cols for r in col)
    wp = ((w + 8 + 3) // 4) * 4
    rows = np.zeros((c, b, wp), np.uint8)
    for i, col in enumerate(cols):
        for j, r in enumerate(col):
            rows[i, j, : len(r)] = np.frombuffer(r, np.uint8)
    got = thd.split_hash_ids(
        torch.from_numpy(rows), torch.from_numpy(delims.copy()),
        torch.from_numpy(buckets), L,
    ).numpy()
    ref = np.asarray(jhd.split_hash_ids(
        jnp.asarray(rows), jnp.asarray(delims), jnp.asarray(buckets),
        rowlen=L,
    ))
    np.testing.assert_array_equal(got, ref)
    for i in range(c):
        d = bytes([delims[i]])
        for j, r in enumerate(cols[i]):
            want = np.full(L, -1, np.int64)
            if r:
                ids = hash_bucket_fast(r.split(d)[:L], int(buckets[i]))
                want[: len(ids)] = ids
            np.testing.assert_array_equal(got[i, j], want, f"{i},{j} {r!r}")


def _verbatim(cols, b, wbk):
    """numpy 'S' buffers copied verbatim, as runtime/wire._fill_verbatim
    stages them: [n, b * wbk] bytes + [n] itemsizes."""
    n = len(cols)
    raw = np.zeros((n, b * wbk), np.uint8)
    widths = np.zeros(n, np.int32)
    for i, col in enumerate(cols):
        arr = np.asarray(col, dtype="S")
        widths[i] = arr.dtype.itemsize
        buf = arr.view(np.uint8).ravel()
        raw[i, : buf.size] = buf
    return raw, widths


@pytest.mark.parametrize("split", [False, True])
def test_hash_verbatim_matches_repad_then_reference(split):
    """The wrapper's CPU path (re-pad + hash) against the reference's
    _verbatim_rows semantics followed by its hash functions."""
    c, b, L = 3, 30, 5
    if split:
        delims, cols = _split_case(9, c, b, True)
    else:
        rng = np.random.default_rng(9)
        delims = None
        cols = [[_piece(rng, int(rng.choice(LENGTHS[:8])), True)
                 for _ in range(b)] for _ in range(c)]
    width = max(np.asarray(col, dtype="S").dtype.itemsize for col in cols)
    wbk = ((width + 4 + 3) // 4) * 4
    raw, widths = _verbatim(cols, b, wbk)
    buckets = np.asarray([7, 1 << 20, 1 << 31], np.int64)
    got = thd.hash_verbatim(
        torch.from_numpy(raw), torch.from_numpy(widths),
        torch.from_numpy(buckets),
        torch.from_numpy(thd.bucket_reciprocals(buckets)),
        None if delims is None else torch.from_numpy(delims.copy()),
        b, wbk, L,
    ).numpy()
    rows = np.zeros((c, b, wbk), np.uint8)
    for i in range(c):
        w = widths[i]
        rows[i, :, :w] = raw[i, : b * w].reshape(b, w)
    if split:
        ref = np.asarray(jhd.split_hash_ids(
            jnp.asarray(rows), jnp.asarray(delims), jnp.asarray(buckets),
            rowlen=L,
        ))
    else:
        ref = np.asarray(jhd.fixed_hash_ids(
            jnp.asarray(rows), jnp.asarray(buckets)
        ))[..., None]
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_hash_verbatim_rejects_bad_inputs():
    raw = torch.zeros((2, 4 * 8), dtype=torch.uint8)
    widths = torch.full((2,), 4, dtype=torch.int32)
    buckets = torch.full((2,), 10, dtype=torch.int64)
    recips = torch.from_numpy(thd.bucket_reciprocals(buckets.numpy()))
    with pytest.raises(ValueError, match="raw"):
        thd.hash_verbatim(raw, widths, buckets, recips, None, 4, 12)
    with pytest.raises(ValueError, match="buckets"):
        thd.hash_verbatim(raw, widths, buckets.int(), recips, None, 4, 8)
    with pytest.raises(ValueError, match="recips"):
        thd.hash_verbatim(raw, widths, buckets, recips[:1], None, 4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_x2_kernel_matches_plain_on_card(cuda, split):
    c, b, L = 3, 300, 7
    if split:
        delims, cols = _split_case(11, c, b, True)
    else:
        rng = np.random.default_rng(11)
        delims = None
        cols = [[_piece(rng, int(rng.choice(LENGTHS)), True)
                 for _ in range(b)] for _ in range(c)]
    width = max(np.asarray(col, dtype="S").dtype.itemsize for col in cols)
    wbk = ((width + 4 + 3) // 4) * 4
    raw, widths = _verbatim(cols, b, wbk)
    buckets = np.asarray([7, 1 << 20, 1 << 31], np.int64)
    raw_t = torch.from_numpy(raw).to(cuda)
    widths_t = torch.from_numpy(widths).to(cuda)
    buckets_t = torch.from_numpy(buckets).to(cuda)
    delims_t = (None if delims is None
                else torch.from_numpy(delims.copy()).to(cuda))
    before = kernels.launches["X2"]
    got = thd.hash_verbatim(
        raw_t, widths_t, buckets_t,
        torch.from_numpy(thd.bucket_reciprocals(buckets)).to(cuda),
        delims_t, b, wbk, L,
    )
    assert kernels.launches["X2"] == before + 1
    want = thd.hash_verbatim_plain(raw_t, widths_t, buckets_t, delims_t, b,
                                   wbk, 1 if delims is None else L)
    assert bool((got == want).all())


# ---------------------------------------------------------------------------
# the kernel's modulo: M = floor((2^64 - 1) / m), r = h - umulhi(h, M) * m
# ---------------------------------------------------------------------------


def _umulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of the 128-bit product of uint64 arrays, from 32-bit
    halves (every partial sum stays below 2^64)."""
    a_lo, a_hi = a & M32, a >> np.uint64(32)
    b_lo, b_hi = b & M32, b >> np.uint64(32)
    lh, hl = a_lo * b_hi, a_hi * b_lo
    mid = ((a_lo * b_lo) >> np.uint64(32)) + (lh & M32) + (hl & M32)
    return (a_hi * b_hi + (lh >> np.uint64(32)) + (hl >> np.uint64(32))
            + (mid >> np.uint64(32)))


def _kernel_mod(h: np.ndarray, m: int, recip: np.int64) -> np.ndarray:
    """csrc/hash_device.cu::ModBuckets in numpy: the quotient from the
    reciprocal, the remainder in 32 bits, one correction."""
    q = _umulhi64(h, np.full_like(h, np.int64(recip).view(np.uint64)))
    r = ((h & M32) - (q & M32) * np.uint64(m)) & M32
    return np.where(r >= np.uint64(m), r - np.uint64(m), r)


@pytest.mark.parametrize("m", [1, 2, 3, 7, 10_000, 1 << 23]
                         + BUCKETS_NEAR_2_31)
def test_bucket_reciprocals_give_exact_modulo(m):
    recip = thd.bucket_reciprocals([m])
    assert recip.dtype == np.int64 and recip.shape == (1,)
    assert int(recip.view(np.uint64)[0]) == ((1 << 64) - 1) // m
    rng = np.random.default_rng(m % 1009)
    h = rng.integers(0, 1 << 64, 20_000, dtype=np.uint64)
    edges = [0, 1, 1 << 63, (1 << 64) - 1, (1 << 63) - 1, (1 << 63) + 1,
             m - 1, m, m + 1, (1 << 32) - 1, 1 << 32]
    h[: len(edges)] = np.asarray(edges, np.uint64)
    # multiples of m and their neighbours: where a short quotient shows
    k = rng.integers(0, ((1 << 64) - 1) // m, 2000, dtype=np.uint64)
    h[20: 2020] = k * np.uint64(m)
    h[2020: 4020] = k * np.uint64(m) + np.uint64(m - 1)
    np.testing.assert_array_equal(_kernel_mod(h, m, recip[0]),
                                  h % np.uint64(m))


def test_bucket_reciprocals_reject_out_of_range():
    edges = chip_smoke.EDGE_BUCKETS
    np.testing.assert_array_equal(
        thd.bucket_reciprocals(np.asarray(edges)).view(np.uint64),
        np.asarray([((1 << 64) - 1) // m for m in edges], np.uint64))
    for bad in ([0], [(1 << 31) + 1], [5, -3]):
        with pytest.raises(ValueError, match="bucket counts"):
            thd.bucket_reciprocals(bad)


def test_hash_constants_carry_reciprocals():
    """The engine's per-(model, device) hash constants hold each group's
    reciprocals beside its bucket counts."""
    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import make_model_e
    from recom_tpu_torch.runtime.wire import _hash_constants

    eng = Engine(make_model_e(scale=0.02), EngineConfig(), device="cpu")
    consts = _hash_constants(eng.compiled, torch.device("cpu"))
    seen = 0
    for group in consts:
        for name in ("str", "fast"):
            if f"{name}_buckets" not in group:
                continue
            b = group[f"{name}_buckets"].numpy()
            np.testing.assert_array_equal(group[f"{name}_recips"].numpy(),
                                          thd.bucket_reciprocals(b))
            seen += 1
    assert seen == 3          # the fixed strings and the two list groups
    assert _hash_constants(eng.compiled, torch.device("cpu")) is consts


# ---------------------------------------------------------------------------
# the kernel's edges (chip_smoke.x2_edge_cases): wide rows, more pieces than
# L = 128, delimiters first, last, everywhere and >= 0x80, odd itemsizes,
# row counts off the block's, every length branch, bucket counts 1 .. 2^31
# ---------------------------------------------------------------------------

EDGE_IDS = ["wide_many_pieces", "high_delim_all_lengths", "fixed_odd_itemsizes"]


def _oracle_ids(case):
    out = np.full((len(case["cols"]), case["bp"], case["rowlen"]), -1,
                  np.int64)
    for i, col in enumerate(case["cols"]):
        m = chip_smoke.EDGE_BUCKETS[i]
        for j, r in enumerate(col):
            if case["delim"] is None:
                out[i, j, 0] = hash_bucket_fast([r], m)[0]
            elif r:
                ids = hash_bucket_fast(
                    r.split(bytes([case["delim"]]))[: case["rowlen"]], m)
                out[i, j, : len(ids)] = ids
    return out


def _edge_args(case, device):
    buckets = np.asarray(chip_smoke.EDGE_BUCKETS, np.int64)
    delim = case["delim"]
    return (
        torch.from_numpy(case["raw"]).to(device),
        torch.from_numpy(case["widths"]).to(device),
        torch.from_numpy(buckets).to(device),
        torch.from_numpy(thd.bucket_reciprocals(buckets)).to(device),
        None if delim is None else torch.full(
            (len(buckets),), delim, dtype=torch.uint8, device=device),
        case["bp"], case["wbk"], case["rowlen"],
    )


@pytest.mark.parametrize("k", range(len(EDGE_IDS)), ids=EDGE_IDS)
def test_hash_verbatim_edges_match_oracle(k):
    """The CPU path on the kernel's edge inputs against the oracle."""
    case = chip_smoke.x2_edge_cases()[k]
    got = thd.hash_verbatim(*_edge_args(case, "cpu")).numpy()
    np.testing.assert_array_equal(got, _oracle_ids(case))


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(EDGE_IDS)), ids=EDGE_IDS)
def test_x2_kernel_edges_match_plain_on_card(cuda, k):
    args = _edge_args(chip_smoke.x2_edge_cases()[k], cuda)
    got = thd.hash_verbatim(*args)
    want = thd.hash_verbatim_plain(*args[:3], *args[4:])
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert bool((got == want).all())
