"""The port's uplink codecs and cohort encodes against the reference's, on
the CPU.

- ``optim/compression.py``: each single-vector and batched codec on the
  same numpy rows as ``repro.optim.compression`` (the reference's eager
  calls): top-k indices in the reference's order (so also as a set), the
  values, ``sent``, the new residuals, the int8 codes, scales and
  dequantized rows, on random rows and on rows with ties across the k-th
  place, signed zeros, NaN and infinities. Bit for bit (NaN at the same
  places).
- ``kernels/uplink.py``: the plain cohort encodes against the reference's
  jitted ``_encode_int8`` and ``_encode_topk``, bit for bit, with the
  anchors and residuals written in place and the plane's other rows left
  alone. XLA fuses two int8 steps into FMAs; the tests pin both (the
  two-op forms would fail) and the single rounding of ``fma_f32`` at the
  corner where float64 double rounding goes wrong.
- ``fl/uplink.py``: ``resolve_k`` and ``resolve_chunk`` over a grid,
  ``wire_bytes == payload_bytes``, and the ``UplinkCodec`` behaviours of
  the reference's ``tests/test_uplink.py::TestUplinkCodec`` that the port
  carries (checkpoints and release are not carried), plus a sequence of
  encodes and installs held to the reference's codec bit for bit.

The reference's ``REPRO_UPLINK*`` variables are unset; the port reads none.
"""
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.fl.uplink import UPLINK_MODES, UplinkCodec, UplinkConfig, resolve_uplink
from repro_torch.kernels import uplink as K
from repro_torch.optim import compression as T
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules. JAX is imported here, not with this module:
    the card's tests and ``chip_smoke.py`` import ``encode_inputs`` on a
    machine without JAX."""
    import jax.numpy as jnp

    from repro.fl import uplink
    from repro.optim import compression

    return SimpleNamespace(jnp=jnp, J=compression, uplink=uplink)


@pytest.fixture(autouse=True)
def _no_uplink_env(monkeypatch):
    for name in ("REPRO_UPLINK", "REPRO_UPLINK_K", "REPRO_UPLINK_CHUNK"):
        monkeypatch.delenv(name, raising=False)


def _rows(kind: str, b: int, n: int, seed: int) -> np.ndarray:
    """(b, n) float32 rows of one kind: random, ties (a few magnitudes,
    repeated across the k-th place), signed zeros, NaN or infinities."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)).astype(np.float32)
    if kind == "ties":
        x = rng.choice(np.float32([-3, -2, -1, 1, 2, 3, 0.5, -0.5]), size=(b, n)).astype(np.float32)
    elif kind == "zeros":
        x = np.where(rng.uniform(size=(b, n)) < 0.5, np.float32(0.0), np.float32(-0.0)).astype(np.float32)
        x[:, ::7] = rng.standard_normal(x[:, ::7].shape)
    elif kind == "nan":
        x[:, 3 % n] = np.nan
        x[:, n // 2] = -np.nan
    elif kind == "inf":
        x[:, 1 % n] = np.inf
        x[:, (n - 2) % n] = -np.inf
    return x


KINDS = ("random", "ties", "zeros", "nan", "inf")


def _assert_same(got, want):
    """NaN at the same places, every other element bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------ single vector
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(40, 4), (40, 13), (41, 41), (5, 9), (300, 30)])
def test_topk_and_ef_step_match_the_reference(kind, n, k, ref):
    v, r = _rows(kind, 2, n, n * 7 + k)
    got, want = T.topk_compress(_t(v), k), ref.J.topk_compress(ref.jnp.asarray(v), k)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.indices.dtype == torch.int32 and got.length == want.length
    _assert_same(got.values.numpy(), want.values)
    _assert_same(T.topk_decompress(got).numpy(), ref.J.topk_decompress(want))
    gp, gs = T.ef_topk_step(_t(v), T.ErrorFeedbackState(_t(r)), k)
    wp, ws = ref.J.ef_topk_step(ref.jnp.asarray(v), ref.J.ErrorFeedbackState(ref.jnp.asarray(r)), k)
    np.testing.assert_array_equal(gp.indices.numpy(), np.asarray(wp.indices))
    _assert_same(gp.values.numpy(), wp.values)
    _assert_same(gs.residual.numpy(), ws.residual)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,chunk", [(40, 8), (41, 8), (7, 16), (100, 33), (1000, 512), (4550, 512)])
def test_int8_single_matches_the_reference(kind, n, chunk, ref):
    v = _rows(kind, 1, n, n + chunk)[0]
    got, want = T.int8_compress(_t(v), chunk), ref.J.int8_compress(ref.jnp.asarray(v), chunk)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.q.dtype == torch.int8 and got.chunk == want.chunk
    _assert_same(got.scales.numpy(), want.scales)
    _assert_same(T.int8_decompress(got).numpy(), ref.J.int8_decompress(want))


# ----------------------------------------------------------------- batched
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,n,k", [(3, 40, 5), (4, 455, 46), (2, 2304, 230), (1, 17, 17)])
def test_topk_batch_codecs_match_the_reference(kind, b, n, k, ref):
    mat, res = _rows(kind, b, n, b * n + k), _rows("random", b, n, k)
    gi, gv = T.topk_compress_batch(_t(mat), k)
    wi, wv = ref.J.topk_compress_batch(ref.jnp.asarray(mat), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _assert_same(gv.numpy(), wv)
    _assert_same(T.topk_scatter_batch(gi, gv, n).numpy(), ref.J.topk_scatter_batch(wi, wv, n))
    got, want = T.ef_topk_batch(_t(mat), _t(res), k), ref.J.ef_topk_batch(ref.jnp.asarray(mat), ref.jnp.asarray(res), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):  # values, sent, new residuals
        _assert_same(g.numpy(), w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,n,chunk", [(3, 41, 8), (2, 4550, 512), (1, 2304, 512), (2, 1000, 1024)])
def test_int8_batch_codecs_match_the_reference(kind, b, n, chunk, ref):
    mat = _rows(kind, b, n, b + n + chunk)
    gq, gs = T.int8_compress_batch(_t(mat), chunk)
    wq, ws = ref.J.int8_compress_batch(ref.jnp.asarray(mat), chunk)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    _assert_same(gs.numpy(), ws)
    _assert_same(T.int8_decompress_batch(gq, gs, chunk).numpy(), ref.J.int8_decompress_batch(wq, ws, chunk))


def test_topk_order_is_lax_top_k_on_ties_nan_and_signed_zeros(ref):
    v = np.float32([1, 3, 3, 2, 3, 0, -0.0, np.nan, np.inf, -np.nan, -np.inf])
    want = [7, 9, 8, 10, 1, 2, 4, 3, 0, 5, 6]  # NaNs, then infinities, then 3s, each by index
    got = T.topk_compress(_t(v), len(v)).indices.tolist()
    assert got == want == np.asarray(ref.J.topk_compress(ref.jnp.asarray(v), len(v)).indices).tolist()


# --------------------------------------------------------- cohort encodes
ENCODE_SHAPES = [(4, 4550, 512, 455), (3, 2304, 512, 230), (1, 25418, 512, 2542), (2, 8193, 7, 1),
                 (3, 37, 37, 37), (1, 1, 1, 1), (5, 1000, 1000, 100)]


def encode_inputs(kind, b, n, seed):
    """Anchors, residuals and trained rows: the trained rows a small step
    from the anchors, except in the special rows' places."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, n)).astype(np.float32)
    R = (0.01 * rng.standard_normal((b, n))).astype(np.float32)
    step = _rows(kind, b, n, seed + 1) * np.float32(0.05)
    mat = (A + step).astype(np.float32)
    if kind == "ties":  # equal |c| across the k-th place: anchors and residuals out of the way
        A[:, : n // 2] = 0.0
        R[:, : n // 2] = 0.0
        mat[:, : n // 2] = step[:, : n // 2]
    if kind == "zeros":  # c = +-0 with +-0 anchors
        A[:, ::2] = -0.0
        R[:, ::3] = 0.0
        mat[:, ::2] = np.where(rng.uniform(size=mat[:, ::2].shape) < 0.5, 0.0, -0.0)
        R[:, ::2] = -0.0
    return A, R, mat


def _ref_int8(ref, A, mat, chunk):
    """The reference's jitted int8 cohort encode: (B, n) reconstructions."""
    sel = np.arange(A.shape[0], dtype=np.int32)
    return np.asarray(ref.uplink._encode_int8(ref.jnp.asarray(A), sel, ref.jnp.asarray(mat), chunk=chunk))


def _ref_topk(ref, A, R, mat, k):
    """The reference's jitted top-k cohort encode: reconstructions, residuals."""
    sel = np.arange(A.shape[0], dtype=np.int32)
    rec, res = ref.uplink._encode_topk(ref.jnp.asarray(A), ref.jnp.asarray(R), sel, ref.jnp.asarray(mat), k=k)
    return np.asarray(rec), np.asarray(res)


def encode_plane(A, R, b):
    """A plane of 2 b + 2 rows: the anchors and residuals at the rows of a
    seeded permutation, and two rows no encode may touch. Returns the plane
    and the anchor and residual row ids."""
    n = A.shape[1]
    cap = 2 * b + 2
    rng = np.random.default_rng(b)
    store = rng.standard_normal((cap, n)).astype(np.float32)
    rows = np.random.default_rng(n).permutation(cap)
    a_rows, r_rows = rows[:b], rows[b:2 * b]
    store[a_rows], store[r_rows] = A, R
    return torch.from_numpy(store), torch.from_numpy(a_rows.astype(np.int64)), torch.from_numpy(r_rows.astype(np.int64))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,n,chunk,k", ENCODE_SHAPES)
def test_int8_encode_plain_is_the_reference_bit_for_bit(kind, b, n, chunk, k, ref):
    A, R, mat = encode_inputs(kind, b, n, b * n)
    plane, a_rows, r_rows = encode_plane(A, R, b)
    before, trained = plane.clone(), _t(mat.copy())
    rec = K.uplink_int8_encode(plane, a_rows, trained, chunk)
    want = _ref_int8(ref, A, mat, chunk)
    _assert_same(rec.numpy(), want)
    _assert_same(plane[a_rows].numpy(), want)
    untouched = np.setdiff1d(np.arange(plane.shape[0]), a_rows.numpy())
    _assert_same(plane[untouched].numpy(), before[untouched].numpy())
    _assert_same(trained.numpy(), mat)  # only read


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,n,chunk,k", ENCODE_SHAPES)
def test_topk_encode_plain_is_the_reference_bit_for_bit(kind, b, n, chunk, k, ref):
    A, R, mat = encode_inputs(kind, b, n, b * n + 1)
    plane, a_rows, r_rows = encode_plane(A, R, b)
    before = plane.clone()
    rec = K.uplink_topk_encode(plane, a_rows, r_rows, _t(mat), k)
    want_rec, want_r = _ref_topk(ref, A, R, mat, k)
    _assert_same(rec.numpy(), want_rec)
    _assert_same(plane[a_rows].numpy(), want_rec)
    _assert_same(plane[r_rows].numpy(), want_r)
    untouched = np.setdiff1d(np.arange(plane.shape[0]), np.concatenate([a_rows.numpy(), r_rows.numpy()]))
    _assert_same(plane[untouched].numpy(), before[untouched].numpy())


@pytest.mark.parametrize("b,k", [(1, 2), (2, 1), (2, 2)])
def test_topk_encode_adds_where_nothing_was_sent(b, k, ref):
    """-0 + 0 is +0: an anchor of -0 where nothing was sent becomes +0, as
    the reference's ``A + sent`` makes it."""
    A = np.tile(np.float32([[-0.0, -0.0, 1.0, -0.0, -0.0]]), (b, 1))
    mat = np.tile(np.float32([[-0.0, 5.0, 1.0, -0.0, 4.0]]), (b, 1))
    plane, a_rows, r_rows = encode_plane(A, np.zeros_like(A), b)
    rec = K.uplink_topk_encode(plane, a_rows, r_rows, _t(mat), k).numpy()
    want, _ = _ref_topk(ref, A, np.zeros_like(A), mat, k)
    _assert_same(rec, want)
    assert not np.signbit(rec[:, [0, 3]]).any() and (rec[:, 1] == 5.0).all()


def test_topk_encode_at_one_row_and_k_one_differs_from_the_reference_on_minus_zero(ref):
    """At one row and k = 1 XLA compiles the reference's ``A + sent`` as an
    update of the one sent element, so an unsent -0 anchor stays -0 there;
    the port adds everywhere, as at every other shape. A fact about the
    reference, not reached by the paths (k = round(0.1 dim) > 1 from dim 15)."""
    A, mat = np.float32([[-0.0, -0.0, 1.0]]), np.float32([[-0.0, 5.0, 1.0]])
    plane, a_rows, r_rows = encode_plane(A, np.zeros_like(A), 1)
    rec = K.uplink_topk_encode(plane, a_rows, r_rows, _t(mat), 1).numpy()
    want = _ref_topk(ref, A, np.zeros_like(A), mat, 1)[0]
    assert np.signbit(want[0, 0]) and not np.signbit(rec[0, 0])
    np.testing.assert_array_equal(rec, want)  # equal as numbers


def test_int8_steps_are_fmas_in_the_reference(ref):
    """The reference's jitted encode rounds ``q * s + A`` and
    ``max * fl(1/127) + 1e-12`` once each: the two-op forms (and the eager
    codec's true division for the scale) differ from it on these rows,
    the plain encode does not."""
    rng = np.random.default_rng(0)
    b, n, chunk = 4, 25418, 512
    A = rng.standard_normal((b, n)).astype(np.float32)
    mat = (A + rng.standard_normal((b, n)).astype(np.float32) * np.float32(0.05)).astype(np.float32)
    want = _ref_int8(ref, A, mat, chunk)
    plane, a_rows, _ = encode_plane(A, A, b)
    _assert_same(K.uplink_int8_encode(plane, a_rows, _t(mat), chunk).numpy(), want)
    q, s = T.int8_compress_batch(_t(mat - A), chunk)  # the eager scale: max / 127.0 + 1e-12
    d = torch.nn.functional.pad(_t(mat - A), (0, (-n) % chunk)).reshape(b, -1, chunk)
    mx = torch.amax(torch.abs(d), dim=-1)
    fused = K.fma_f32(mx, torch.full_like(mx, K.INV_127), torch.full_like(mx, 1e-12))
    assert torch.count_nonzero(fused != s) > 0  # the scale: one rounding, not two
    sf = np.repeat(fused.numpy(), chunk, axis=1)[:, :n]
    two_op = (A + (q.numpy().astype(np.float32) * sf).astype(np.float32)).astype(np.float32)
    assert np.count_nonzero(two_op.view(np.uint32) != want.view(np.uint32)) > 100  # the reconstruction too


def _exact_f32(x: Fraction) -> float:
    """``x`` rounded once to the nearest fp32 (ties to even), from the exact value."""
    f = np.float32(float(x))  # within an ulp; the exact distances decide
    cands = {float(f), float(np.nextafter(f, np.float32(np.inf))), float(np.nextafter(f, np.float32(-np.inf)))}
    return min(cands, key=lambda c: (abs(Fraction(c) - x), int(np.float32(c).view(np.uint32)) & 1))


@pytest.mark.parametrize("q,s_mant,s_exp,a,corner", [
    (65.0, 16519105, -54, 1.0, True),  # q s = 2**-24 + 2**-54: float64 rounds to the halfway point, then to even
    (-65.0, 16519105, -54, -1.0, True),
    (65.0, 16519105, -30, 2.0 ** 24, True),
    (77.0, 13944699, -54, 1.0, False),  # q s = 2**-24 - 2**-54: below the halfway point either way
    (3.0, 11184811, -24, 0.5, False),  # an ordinary sum
])
def test_fma_f32_rounds_once_where_float64_rounds_twice(q, s_mant, s_exp, a, corner):
    s = np.float32(s_mant * 2.0 ** s_exp)
    assert float(s) == s_mant * 2.0 ** s_exp  # exact in fp32
    exact = Fraction(q) * Fraction(float(s)) + Fraction(a)
    want = _exact_f32(exact)
    got = K.fma_f32(torch.tensor([q]), torch.tensor([float(s)]), torch.tensor([a])).item()
    assert got == want
    twice = float(np.float32(q * float(s) + a))  # float64 sum, then fp32
    assert (twice != want) == corner  # the corner the round-to-odd step closes


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("k", [0.1, 0.05, 0.5, 0.999, 1, 7, 17, 455.0, 10_000])
@pytest.mark.parametrize("dim", [1, 3, 5, 36, 100, 2304, 4550, 25418, 783360])
def test_resolve_k_chunk_and_wire_bytes_match_the_reference(k, dim, ref):
    chunk = int(max(1, k * 50))
    got, want = UplinkConfig(mode="topk", k=k, chunk=chunk), ref.uplink.UplinkConfig(mode="topk", k=k, chunk=chunk)
    assert got.resolve_k(dim) == want.resolve_k(dim)
    assert got.resolve_chunk(dim) == want.resolve_chunk(dim)
    kk, cc = got.resolve_k(dim), got.resolve_chunk(dim)
    for mode in ("topk", "int8"):
        wb = T.wire_bytes(mode, dim, k=kk, chunk=cc)
        assert wb == ref.J.wire_bytes(mode, dim, k=kk, chunk=cc)
    v = torch.linspace(-1, 1, dim)
    assert T.wire_bytes("topk", dim, k=kk) == T.payload_bytes(T.topk_compress(v, kk))
    assert T.wire_bytes("int8", dim, chunk=cc) == T.payload_bytes(T.int8_compress(v, cc))


def test_config_takes_arguments_and_never_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_UPLINK", "topk")
    monkeypatch.setenv("REPRO_UPLINK_K", "0.25")
    monkeypatch.setenv("REPRO_UPLINK_CHUNK", "64")
    assert resolve_uplink(None) == UplinkConfig() and resolve_uplink(None).mode == "none"
    assert resolve_uplink(" TopK ") == UplinkConfig(mode="topk", k=0.1, chunk=512)
    assert resolve_uplink("int8").chunk == 512 and resolve_uplink("").mode == "none"
    cfg = UplinkConfig(mode="int8", chunk=7)
    assert resolve_uplink(cfg) is cfg
    assert UPLINK_MODES == ("none", "topk", "int8")
    for bad in (dict(mode="gzip"), dict(k=0.0), dict(chunk=0)):
        with pytest.raises(ValueError):
            UplinkConfig(**bad)
    with pytest.raises(TypeError):
        T.payload_bytes(object())
    with pytest.raises(ValueError):
        T.wire_bytes("gzip", 10)


# ------------------------------------------------------------ UplinkCodec
def _template(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax_tree(ref, tree):
    return {k: ref.jnp.asarray(v) for k, v in tree.items()}


def _codec(mode="topk", cids=(0, 1, 2, 3), **kw):
    codec = UplinkCodec(_torch_tree(_template()), list(cids), UplinkConfig(mode=mode, **kw), device="cpu")
    codec.seed({c: _torch_tree(_template()) for c in cids})
    return codec


def _flat(codec, tree):
    return codec.spec.flatten(tree).numpy()


def test_codec_rejects_none_mode_and_unseeded_or_repeated_clients():
    with pytest.raises(ValueError):
        UplinkCodec(_torch_tree(_template()), [0], UplinkConfig(mode="none"), device="cpu")
    codec = UplinkCodec(_torch_tree(_template()), [0, 1], UplinkConfig(mode="topk"), device="cpu")
    codec.seed({0: _torch_tree(_template())})
    with pytest.raises(ValueError):
        codec.encode(1, _torch_tree(_template(1)))
    with pytest.raises(ValueError):
        codec.encode_rows([0, 0], torch.zeros((2, codec.dim)))
    assert codec.launches == 0


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_codec_cohort_is_the_per_client_encodes(mode):
    ca, cb = _codec(mode), _codec(mode)
    for seed in (1, 5):
        models = {c: _torch_tree(_template(seed + c)) for c in (0, 1, 2)}
        mat = torch.stack([ca.spec.flatten(models[c]) for c in (0, 1, 2)])
        recs, nbytes = ca.encode_rows([0, 1, 2], mat)
        assert nbytes == ca.nbytes
        for c in (0, 1, 2):
            rec, nb = cb.encode(c, models[c])
            assert nb == nbytes
            _assert_same(_flat(cb, rec), _flat(ca, recs[c]))
    assert ca.launches == 2 and cb.launches == 6


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_codec_anchor_advances_to_the_reconstruction(mode):
    codec = _codec(mode)
    rec, _ = codec.encode(2, _torch_tree(_template(7)))
    _assert_same(codec.plane.row(codec._anchor_row[codec.index[2]]).numpy(), _flat(codec, rec))


def test_codec_topk_with_k_the_dim_sends_everything():
    codec = _codec("topk", k=10_000)
    m = _torch_tree(_template(1))
    rec, nbytes = codec.encode(1, m)
    assert not codec.plane.row(codec._resid_row[codec.index[1]]).any()
    np.testing.assert_allclose(_flat(codec, rec), _flat(codec, m), rtol=1e-5, atol=1e-7)
    assert nbytes == codec.dim * 8


def test_codec_launches_once_a_cohort():
    codec = _codec("topk", cids=list(range(8)))
    for cohort in ([0], [1, 2], [3, 4, 5], [6, 7]):
        mat = torch.stack([codec.spec.flatten(_torch_tree(_template(c))) for c in cohort])
        codec.encode_rows(cohort, mat)
    assert codec.launches == 4


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_codec_nbytes_static_and_exact(mode, ref):
    codec = _codec(mode, chunk=16)
    assert codec.nbytes == T.payload_bytes(codec.payload_template())
    want = codec.k * 8 if mode == "topk" else codec.dim + (-(-codec.dim // codec.chunk)) * 4
    assert codec.nbytes == want
    theirs = ref.uplink.UplinkCodec(_jax_tree(ref, _template()), [0, 1, 2, 3],
                                    ref.uplink.UplinkConfig(mode=mode, chunk=16))
    assert (codec.nbytes, codec.k, codec.chunk, codec.dim) == (theirs.nbytes, theirs.k, theirs.chunk, theirs.dim)


def test_codec_seed_skips_clients_seeded_already():
    codec = _codec("topk", cids=[0, 1])
    rec, _ = codec.encode(0, _torch_tree(_template(3)))
    codec.seed({0: _torch_tree(_template(9)), 1: _torch_tree(_template(9))})
    _assert_same(codec.plane.row(codec._anchor_row[0]).numpy(), _flat(codec, rec))


def test_codec_install_moves_the_anchor_and_drops_the_residual():
    codec = _codec("topk", cids=[0, 1])
    codec.encode(1, _torch_tree(_template(4)))
    assert codec.plane.row(codec._resid_row[1]).any()
    model = _torch_tree(_template(6))
    codec.install(1, model)
    codec.install(5, model)  # not a client of this codec: ignored
    _assert_same(codec.plane.row(codec._anchor_row[1]).numpy(), _flat(codec, model))
    assert not codec.plane.row(codec._resid_row[1]).any()


@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_codec_sequence_is_the_reference_codec_bit_for_bit(mode, ref):
    """Seed, cohorts of 3 and 2, a per-event encode, installs (a broadcast's
    one object to two clients), then more encodes: every reconstruction and
    every anchor and residual row as the reference's codec leaves them."""
    cids = [0, 1, 2, 3]
    cfg = dict(mode=mode, k=0.2, chunk=8)
    port = UplinkCodec(_torch_tree(_template()), cids, UplinkConfig(**cfg), device="cpu")
    theirs = ref.uplink.UplinkCodec(_jax_tree(ref, _template()), cids, ref.uplink.UplinkConfig(**cfg))
    port.seed({c: _torch_tree(_template()) for c in cids})
    theirs.seed({c: _jax_tree(ref, _template()) for c in cids})
    rng = np.random.default_rng(11)

    def step(cohort):
        mats = rng.standard_normal((len(cohort), port.dim)).astype(np.float32)
        got, _ = port.encode_rows(cohort, torch.from_numpy(mats))
        want, _ = theirs.encode_rows(cohort, ref.jnp.asarray(mats))
        for g, w in zip(got, want):
            _assert_same(_flat(port, g), np.asarray(theirs.spec.flatten(w)))

    step([0, 1, 2])
    step([3, 1])
    tree = _template(21)
    for c in (0, 2):
        port.install(c, _torch_tree(tree) if c == 0 else port._install_memo[0])
        theirs.install(c, _jax_tree(ref, tree) if c == 0 else theirs._install_memo[0])
    m = _template(22)
    got, _ = port.encode(2, _torch_tree(m))
    want, _ = theirs.encode(2, _jax_tree(ref, m))
    _assert_same(_flat(port, got), np.asarray(theirs.spec.flatten(want)))
    step([2, 0, 3, 1])
    rows = [port._anchor_row] + ([port._resid_row] if mode == "topk" else [])
    their_rows = [theirs._anchor_row] + ([theirs._resid_row] if mode == "topk" else [])
    for mine, their in zip(rows, their_rows):
        for c in cids:
            _assert_same(port.plane.row(mine[c]).numpy(), np.asarray(theirs.plane.row(their[c])))
    assert port.launches == theirs.launches == 4
