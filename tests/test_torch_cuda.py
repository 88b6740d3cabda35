"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no CPU
mode); they import no JAX, so they run on a machine with only the port's
dependencies: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerances as in ``chip_smoke.py``: L1 and chi2 rtol 1e-5 (and the L1
and chi2 sums bitwise those of the numpy models of their orders), the blend
bitwise, the index equal, the merge bitwise its plain version (NaN at the
same places), the flash forward 1e-5 and backward 3e-4 (the backward also
bitwise across repeats), the bf16 flash kernels within one bf16 ulp or
1e-5 (``tests/torch_bf16_bounds.py``); the ingest chain's cids, blended rows and carried
matrix bitwise its plain version's and its distances and statistics
bitwise the numpy model of the L1 order (``kernel_chain``), with and without
the guard's norm statistic. The ``har``
FedAvg and FedAsyn runs on the card against the same runs on the CPU:
identical ledgers and stats, accuracy curves within 0.02. The uplink
encodes bitwise their plain versions (NaN at the same places) at the paths'
widths, B = 1, 3 and 32, on tie, signed-zero, NaN and inf rows, one kernel
a call, one a codec cohort; compressed ``har`` runs card against CPU.
Reduced gemma2's, deepseek-v2-lite's and jamba's decode against their
teacher-forced full forward within 1e-4 (one flash forward an attention
layer in the prefill, none in the decode), reduced hubert's forward card
against CPU within 1e-4, and the pytree backend's assign as one
``l1_distance`` launch. Training: remat on and off bit for bit, a
``TrainState`` saved from the card restored on the CPU, and the EchoPFL
transformer-client example card against CPU. The broadcast RNN kernel
(``csrc/rnn.cu``, ``-k rnn``): one SGD step within rtol 1e-6, atol 1e-7 of
the plain version, a chain of 32 steps within rtol 1e-5, atol 1e-6, the
decisions identical wherever the plain logit margin exceeds 1e-5, the
pretraining within 4 times its fp32-against-fp64 gap
(``tests/torch_rnn_model.py``); a chain bit for bit the same steps as
per-event launches, every launch repeating its bits, one launch a chain and
a pretraining, and a parent's weights untouched by its child's learning.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import assign_lerp, chi2, l1, merge, ops


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _feedback(rng, m, j):
    f_pred = (rng.uniform(size=(m, j)) * 100).astype(np.float32)
    f_true = (rng.uniform(size=(m, j)) * 100 + 1.0).astype(np.float32)
    z = rng.standard_normal((m, j))
    s_soft = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    return f_pred, f_true, s_soft


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4550, 25418, 4099])
def test_cuda_kernels_match_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    dev = cuda_device
    cs = torch.from_numpy(_f32(rng, 5, n)).to(dev)
    u = torch.from_numpy(_f32(rng, n)).to(dev)
    d, i, b = ops.assign_and_lerp(u, cs, 0.25)
    dp, ip, bp = assign_lerp.assign_and_lerp_plain(u, cs, 0.25)
    torch.testing.assert_close(d, dp, rtol=1e-5, atol=0)
    assert int(i) == int(ip)
    assert torch.equal(b, bp)
    xs = torch.from_numpy(_f32(rng, 8, n)).to(dev)
    torch.testing.assert_close(ops.l1_distance_pairwise(xs, cs),
                               l1.l1_distance_pairwise_plain(xs, cs), rtol=1e-5, atol=0)
    assert torch.equal(_bits(ops.merge_attention(u, cs[0], cs[1])),
                       _bits(merge.merge_attention_plain(u, cs[0], cs[1])[0]))
    fp, ft, ss = (torch.from_numpy(a).to(dev) for a in _feedback(rng, 64, 10))
    seg = torch.from_numpy(np.arange(64, dtype=np.int32) % 4).to(dev)
    g, s = ops.chi2_feedback_segmented(fp, ft, ss, seg, 4)
    gp, sp = chi2.chi2_feedback_segmented_plain(fp, ft, ss, seg, 4)
    torch.testing.assert_close(g, gp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=1e-5)


def _traced_kernels(run):
    """Names of the device kernels ``run()`` launches, from one padded
    profiler session. The session starts with 32 spin kernels, left out of
    the names: on the H100 the profiler can drop a session's first few
    launches (``chip_smoke._device_trace``). It can still lose kernels
    (never add any), so a caller retries until one session shows all."""
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)
        for _ in range(32):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        time.sleep(0.005)
    return [e.name for e in prof.events() if e.device_type.name == "CUDA" and "spin_kernel" not in e.name]


@pytest.mark.cuda
def test_cuda_wrappers_count_launches(cuda_device):
    ops.reset_launch_counts()
    x = torch.ones(3, 40, device=cuda_device)
    ops.l1_distance_pairwise(x, x)
    ops.assign_and_lerp(x[0], x, 0.5)
    counts = ops.launch_counts()
    assert counts["l1_distance_pairwise"] == 1 and counts["assign_and_lerp"] == 1
    assert counts["l1_distance"] == 0  # the assign computes its distances in its own kernel
    # one port kernel per assign in a trace. The profiler can lose kernels of
    # a short session (never add any), so a session may show fewer, never
    # more or others; one session must show all of them.
    calls, full = 10, False
    for _ in range(5):
        kernels = [k for k in _traced_kernels(lambda: [ops.assign_and_lerp(x[0], x, 0.5) for _ in range(calls)])
                   if "_kernel" in k and any(n in k for n in ("l1_rows", "assign_lerp", "select_lerp"))]
        assert len(kernels) <= calls and all("assign_lerp_kernel" in k for k in kernels), kernels
        if len(kernels) == calls:
            full = True
            break
    assert full, "no profiler session recorded every assign"


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [25418, 4550, 4099, 4097, 1, 783360])
def test_cuda_l1_bits_follow_the_fixed_order(cuda_device, n):
    """Equal rows in different alignment classes get the same bits and the
    tie goes to index 1; every entry point and every repeat gives the bits
    of the numpy model of the order (``tests/test_torch_l1_order.py``)."""
    from test_torch_l1_order import kernel_l1

    rng = np.random.default_rng(n)
    u_np = _f32(rng, n)
    cs_np = _f32(rng, 5, n) + 5.0
    cs_np[1] = u_np + 0.5
    cs_np[2] = cs_np[1]
    u, cs = torch.from_numpy(u_np).to(cuda_device), torch.from_numpy(cs_np).to(cuda_device)
    want = np.asarray([kernel_l1(u_np, r) for r in cs_np], np.float32)
    runs = [ops.assign_and_lerp(u, cs, 0.25) for _ in range(3)]
    d, i, b = runs[0]
    assert int(i) == 1
    np.testing.assert_array_equal(d.cpu().numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(b, assign_lerp.blend_plain(cs[1], u, 0.25))
    for r in runs[1:]:
        assert torch.equal(_bits(r[0]), _bits(d)) and int(r[1]) == 1 and torch.equal(_bits(r[2]), _bits(b))
    xs = torch.stack([cs[0], u])  # u at row 1: another alignment class where N % 4 != 0
    for got in (ops.l1_distance(u, cs), ops.l1_distance_pairwise(xs, cs)[1], ops.pairwise_l1(torch.cat([xs, cs]))[1, 2:]):
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(33, 25418), (33, 4099), (4, 783360), (33, 783360)])
def test_cuda_assign_many_centers_and_full_width(cuda_device, c, n):
    rng = np.random.default_rng(c + n)
    u = torch.from_numpy(_f32(rng, n)).to(cuda_device)
    cs = torch.from_numpy(_f32(rng, c, n)).to(cuda_device)
    d, i, b = ops.assign_and_lerp(u, cs, 0.3)
    dp, _, _ = assign_lerp.assign_and_lerp_plain(u, cs, 0.3)
    torch.testing.assert_close(d, dp, rtol=1e-5, atol=0)
    assert int(i) == int(np.argmin(d.cpu().numpy()))
    assert torch.equal(b, assign_lerp.blend_plain(cs[int(i)], u, 0.3))
    again = ops.assign_and_lerp(u, cs, 0.3)
    assert torch.equal(_bits(again[0]), _bits(d)) and torch.equal(_bits(again[2]), _bits(b))
    torch.testing.assert_close(ops.l1_distance_pairwise(cs[:2], cs), l1.l1_distance_pairwise_plain(cs[:2], cs),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,j", [(m, j) for m in (1, 20, 300, 2049) for j in (2, 10, 16, 200)])
def test_cuda_chi2_bits_follow_the_fixed_order(cuda_device, m, j):
    """g and the segment sums bitwise those of the numpy model of the
    kernel's order (``tests/test_torch_chi2_order.py``) at S = 0, 1, 4 and
    300 (more segments than threads), across repeats, and within rtol 1e-5
    of the plain version. M = 2049 is nine row tiles over an 8-block cluster."""
    from test_torch_chi2_order import kernel_chi2

    rng = np.random.default_rng(m * 1000 + j)
    fp, ft, ss = _feedback(rng, m, j)
    t = [torch.from_numpy(a).to(cuda_device) for a in (fp, ft, ss)]
    want_g, _ = kernel_chi2(fp, ft, ss)
    g = ops.chi2_feedback(*t)
    np.testing.assert_array_equal(g.cpu().numpy().view(np.int32), want_g.view(np.int32))
    torch.testing.assert_close(g, chi2.chi2_feedback_plain(*t), rtol=1e-5, atol=1e-6)
    for s in (0, 1, 4, 300):
        seg = rng.integers(-1, s, m).astype(np.int32)  # -1: no segment
        seg_t = torch.from_numpy(seg).to(cuda_device)
        runs = [ops.chi2_feedback_segmented(*t, seg_t, s) for _ in range(2)]
        wg, ws = kernel_chi2(fp, ft, ss, seg, s)
        for rg, rs in runs:
            assert rg.shape == (m,) and rs.shape == (s,)
            np.testing.assert_array_equal(rg.cpu().numpy().view(np.int32), wg.view(np.int32))
            np.testing.assert_array_equal(rs.cpu().numpy().view(np.int32), ws.view(np.int32))
        gp, sp = chi2.chi2_feedback_segmented_plain(*t, seg_t, s)
        torch.testing.assert_close(runs[0][1], sp, rtol=1e-5, atol=1e-5)
        host_g, host_s = chi2.segmented_numpy(*runs[0])
        assert host_g.tobytes() == wg.tobytes() and host_s.tobytes() == ws.tobytes()


@pytest.mark.cuda
def test_cuda_chi2_is_one_launch_per_call(cuda_device):
    """Each entry point launches exactly one kernel, ``chi2_kernel``, and
    nothing else runs on the device (no second pass, no memset). The
    profiler can lose kernels of a short session (never add any): a session
    may show fewer, never more or others; one session must show all."""
    fp, ft, ss = (torch.from_numpy(a).to(cuda_device) for a in _feedback(np.random.default_rng(2), 20, 10))
    seg = torch.arange(20, dtype=torch.int32, device=cuda_device) % 4
    ops.reset_launch_counts()
    ops.chi2_feedback(fp, ft, ss)
    ops.chi2_feedback_segmented(fp, ft, ss, seg, 4)
    counts = ops.launch_counts()
    assert counts["chi2_feedback"] == 1 and counts["chi2_feedback_segmented"] == 1
    def run():
        for _ in range(calls):
            ops.chi2_feedback(fp, ft, ss)
            ops.chi2_feedback_segmented(fp, ft, ss, seg, 4)

    calls, full = 5, False
    for _ in range(5):
        names = _traced_kernels(run)
        assert len(names) <= 2 * calls and all("chi2_kernel" in n for n in names), names
        if len(names) == 2 * calls:
            full = True
            break
    assert full, "no profiler session recorded every chi2 launch"


@pytest.mark.cuda
def test_cuda_chi2_edges(cuda_device):
    """No rows and S > 0 writes S zeros; S past the shared memory a block
    has raises before anything launches."""
    z = torch.zeros(0, 10, device=cuda_device)
    g, s = ops.chi2_feedback_segmented(z, z, z, torch.zeros(0, dtype=torch.int32, device=cuda_device), 5)
    assert g.shape == (0,) and s.cpu().tolist() == [0.0] * 5
    assert ops.chi2_feedback(z, z, z).shape == (0,)
    fp, ft, ss = (torch.from_numpy(a).to(cuda_device) for a in _feedback(np.random.default_rng(3), 300, 32))
    seg = torch.zeros(300, dtype=torch.int32, device=cuda_device)
    s_max = (chi2.MAX_SMEM - chi2.smem_bytes(300, 32, 0)) // 4
    g, s = ops.chi2_feedback_segmented(fp, ft, ss, seg, s_max)
    torch.testing.assert_close(s[0], g.sum(), rtol=1e-5, atol=1e-5)
    assert int((s[1:] != 0).sum()) == 0
    with pytest.raises(ValueError, match="shared memory"):
        ops.chi2_feedback_segmented(fp, ft, ss, seg, s_max + 1)


FLASH_CASES = [
    # B, H, KV, Sq, Sk, hd, dv, options
    (8, 4, 2, 32, 32, 16, 16, {}),  # tiny_lm training shape
    (16, 32, 8, 256, 256, 64, 64, {}),  # llama3.2-1b: a FedAvg cohort of 4 clients x 4 sequences
    (1, 8, 4, 100, 100, 64, 48, dict(window=32, softcap=30.0)),  # ragged, GQA, dv != hd
    (1, 8, 2, 300, 300, 128, 128, {}),  # head width 128 (llama3-405b, command-r)
    (1, 4, 2, 65, 65, 64, 64, {}),  # one row past a 64-row tile
    (2, 4, 2, 70, 70, 12, 12, {}),  # head width not a multiple of 4: 4-byte copies
]


def _same_nan_bits(got, want):
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and torch.equal(_bits(got[~nan]), _bits(want[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2304, 4099, 4550, 25418, 783360, 4_000_000])
def test_cuda_merge_is_the_plain_version_bit_for_bit(cuda_device, n):
    """On every case of ``merge_cases`` (NaN in each input, +-inf,
    all-negative p, signed zeros): NaN at the plain version's places and
    every other element bitwise, over 3 repeats; a NaN in p makes every
    output NaN. N = 4,000,000 is past one step of the grid on an H100. In
    place on row 1 of a 3-row plane (8-byte aligned where N % 4 = 2), the
    same bits."""
    from test_torch_merge import merge_cases

    for label, rows in merge_cases(np.random.default_rng(n), n).items():
        vm, va, vt = (torch.from_numpy(r).to(cuda_device) for r in rows)
        want = merge.merge_attention_plain(vm, va, vt)[0]
        for _ in range(3):
            assert _same_nan_bits(ops.merge_attention(vm, va, vt), want), label
        if label.startswith("nan"):
            assert bool(torch.isnan(want).all())
    rng = np.random.default_rng(n + 1)
    plane, vt = torch.from_numpy(_f32(rng, 3, n)).to(cuda_device), torch.from_numpy(_f32(rng, n)).to(cuda_device)
    want = merge.merge_attention_plain(plane[1], plane[2], vt)[0]
    row = plane[1]
    assert ops.merge_attention(row, plane[2], vt, out=row) is row
    assert torch.equal(_bits(plane[1]), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2304, 25418, 783360])
def test_cuda_merge_is_one_launch_per_call(cuda_device, n):
    """One ``merge_kernel`` per call and nothing else on the device; the
    profiler can lose kernels of a short session (never add any), so one
    session of five must show all."""
    rng = np.random.default_rng(n)
    vm, va, vt = (torch.from_numpy(_f32(rng, n)).to(cuda_device) for _ in range(3))
    ops.reset_launch_counts()
    ops.merge_attention(vm, va, vt, out=vm)
    assert ops.launch_counts()["merge_attention"] == 1
    calls, full = 10, False
    for _ in range(5):
        names = _traced_kernels(lambda: [ops.merge_attention(vm, va, vt, out=vm) for _ in range(calls)])
        assert len(names) <= calls and all("merge_kernel" in k for k in names), names
        if len(names) == calls:
            full = True
            break
    assert full, "no profiler session recorded every merge"


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_cuda_flash_kernels_match_plain(cuda_device, case):
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import flash_attention_bwd as FB

    B, H, KV, Sq, Sk, hd, dv, kw = case
    rng = np.random.default_rng(Sq)
    q, k, v, do = (torch.from_numpy(_f32(rng, *s)).to(cuda_device)
                   for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, dv), (B, H, Sq, dv)))
    o, lse = F.flash_attention_with_lse(q, k, v, **kw)
    o_p, lse_p = F.flash_attention_with_lse_plain(q, k, v, **kw)
    torch.testing.assert_close(o, o_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    got = FB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = FB.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
    again = FB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_flash_wrappers_count_launches(cuda_device):
    ops.reset_launch_counts()
    q = torch.ones(2, 4, 16, 16, device=cuda_device, requires_grad=True)
    kv = torch.ones(2, 2, 16, 16, device=cuda_device, requires_grad=True)
    ops.attention(q, kv, kv).sum().backward()
    ops.pairwise_l1(torch.ones(3, 40, device=cuda_device))
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] == 1
    assert counts["pairwise_l1"] == 1


# (S, C, N): phase 3d's most frequent segment (25, 4, 25418), tiny_lm's one-chunk row (16, 2, 2304), a
# partial tile across three chunks, the last ragged (12, 5, 8193), and the center limit (3, 1024, 4099),
# whose 512 items are more than the blocks that fit with rows on chip: the rows stay in `carried`
CHAIN_SHAPES = [(1, 1, 1), (8, 3, 4099), (13, 4, 4550), (32, 4, 25418), (4, 2, 783360), (40, 16, 25418),
                (25, 4, 25418), (16, 2, 2304), (12, 5, 8193), (3, 1024, 4099)]


def _chain_inputs(s, c, n, nan_step=None):
    rng = np.random.default_rng(s * 1000 + c * 10 + n % 97)
    centers = _f32(rng, c, n)
    bcast = (centers + 0.3 * _f32(rng, c, n)).astype(np.float32)
    U = _f32(rng, s, n)
    prev = [int(p) if rng.uniform() < 0.7 else -1 for p in rng.integers(0, c, s)]
    forced = [int(p) if rng.uniform() < 0.2 else -1 for p in rng.integers(0, c, s)]
    prev[0] = forced[0] = -1
    kind, pick = rng.integers(0, 3, s), rng.integers(0, c, s)
    for j in range(s):  # near a center; midway between the previous one and another (vetoes); noise
        if kind[j] == 0:
            U[j] = centers[pick[j]] + 0.2 * U[j]
        elif kind[j] == 1 and prev[j] >= 0:
            U[j] = 0.5 * (centers[prev[j]] + centers[pick[j]]) + 0.05 * U[j]
    if nan_step is not None:
        U[nan_step, n // 3] = np.nan
    return U, centers, bcast, prev, forced


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_nan", [(sh, nan) for sh in CHAIN_SHAPES for nan in (False, True)
                                            if not nan or sh[0] >= 4], ids=str)
def test_cuda_ingest_chain_bits(cuda_device, shape, with_nan):
    """The chain kernel against its plain version (on the CPU): cids equal,
    blended rows and carried matrix bitwise; against the numpy model of the
    L1 order (``tests/test_torch_l1_order.py::kernel_chain``): cids equal,
    distances and statistics bitwise (NaN at the same places); bitwise over
    3 repeats; the centers unchanged; one launch counted a call."""
    s, c, n = shape
    U, centers, bcast, prev, forced = _chain_inputs(s, c, n, s // 2 if with_nan else None)
    ops.reset_launch_counts()
    _chain_against_plain_and_model(cuda_device, U, centers, bcast, prev, forced)
    assert ops.launch_counts()["ingest_chain"] == 3


def _chain_against_plain_and_model(dev, U, centers, bcast, prev, forced):
    """Run the chain kernel 3 times and hold it to its plain version and to
    ``kernel_chain`` bit for bit; returns the cids."""
    from test_torch_l1_order import kernel_chain

    from repro_torch.kernels.ingest_chain import ingest_chain_plain

    args = [torch.from_numpy(a).to(dev) for a in (U, centers, bcast)]
    runs = [ops.ingest_chain(*args, prev, forced, beta=0.25) for _ in range(3)]
    got = runs[0]
    plain = ingest_chain_plain(*(torch.from_numpy(a) for a in (U, centers, bcast)), prev, forced, 0.25)
    m_cids, _, m_dists, m_stats, _ = kernel_chain(U, centers, bcast, prev, forced, 0.25)
    assert torch.equal(got.cids.cpu(), plain.cids) and np.array_equal(got.cids.cpu().numpy(), m_cids)
    assert _same_nan_bits(got.blended.cpu(), plain.blended)
    assert _same_nan_bits(got.carried.cpu(), plain.carried)
    assert _same_nan_bits(got.dists.cpu(), torch.from_numpy(m_dists))
    assert _same_nan_bits(got.stats.cpu(), torch.from_numpy(m_stats))
    for r in runs[1:]:
        assert torch.equal(_bits(r.buf), _bits(got.buf)) and torch.equal(_bits(r.carried), _bits(got.carried))
    assert torch.equal(args[1].cpu(), torch.from_numpy(centers))  # the centers are only read
    return got.cids.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_nan", [(sh, nan) for sh in CHAIN_SHAPES for nan in (False, True)
                                            if not nan or sh[0] >= 4], ids=str)
def test_cuda_ingest_chain_with_stats_bits(cuda_device, shape, with_nan):
    """``with_stats=True`` (the guard's post-blend center norm): the four
    statistics bitwise ``kernel_chain(..., with_stats=True)``'s (a NaN
    upload gives a NaN norm), every other output bitwise the chain's
    without the norm, and that chain still bitwise its plain version and
    the model; one launch a call either way."""
    from test_torch_l1_order import kernel_chain

    s, c, n = shape
    U, centers, bcast, prev, forced = _chain_inputs(s, c, n, s // 2 if with_nan else None)
    args = [torch.from_numpy(a).to(cuda_device) for a in (U, centers, bcast)]
    ops.reset_launch_counts()
    off = ops.ingest_chain(*args, prev, forced, beta=0.25)
    on = ops.ingest_chain(*args, prev, forced, beta=0.25, with_stats=True)
    assert ops.launch_counts()["ingest_chain"] == 2
    m_cids, _, _, m_stats, _ = kernel_chain(U, centers, bcast, prev, forced, 0.25, with_stats=True)
    assert on.stats.shape == (s, 4) and _same_nan_bits(on.stats.cpu(), torch.from_numpy(m_stats))
    for a, b in ((off.cids, on.cids), (off.blended, on.blended), (off.dists, on.dists), (off.carried, on.carried),
                 (off.stats, on.stats[:, :3].contiguous())):
        assert _same_nan_bits(a.cpu(), b.cpu())
    assert off.buf.numel() == s * n + s * c + 4 * s and on.buf.numel() == s * n + s * c + 5 * s
    if with_nan:
        assert bool(torch.isnan(on.cnorm[s // 2]))
    _chain_against_plain_and_model(cuda_device, U, centers, bcast, prev, forced)


# (S, C, N): rows on chip; and four rows over 192 chunks (192 items, more than the 132 blocks that
# hold four rows on chip on an H100), kept in `carried`
CHAIN_OWNER_SHAPES = [(32, 4, 25418), (12, 5, 8193), (8, 4, 783360)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAIN_OWNER_SHAPES, ids=str)
def test_cuda_ingest_chain_every_upload_to_one_row(cuda_device, shape):
    """Every upload lies near center 2 and wins it: each step's owners read
    what they blended the step before (a read after their own write across
    steps, with no barrier between)."""
    s, c, n = shape
    rng = np.random.default_rng(s + c + n)
    centers = 3.0 * _f32(rng, c, n)
    bcast = (centers + 0.3 * _f32(rng, c, n)).astype(np.float32)
    U = (centers[2] + 0.1 * _f32(rng, s, n)).astype(np.float32)
    cids = _chain_against_plain_and_model(cuda_device, U, centers, bcast, [-1] * s, [-1] * s)
    assert (cids == 2).all(), cids


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAIN_OWNER_SHAPES, ids=str)
def test_cuda_ingest_chain_forced_ids_walk_every_row(cuda_device, shape):
    """Forced ids take rows 0, 1, ..., C - 1 in turn and around again, so
    every tile's owners blend in turn."""
    s, c, n = shape
    rng = np.random.default_rng(s * c + n)
    centers = _f32(rng, c, n)
    bcast = (centers + 0.3 * _f32(rng, c, n)).astype(np.float32)
    U = _f32(rng, s, n)
    forced = [j % c for j in range(s)]
    cids = _chain_against_plain_and_model(cuda_device, U, centers, bcast, [-1] * s, forced)
    assert list(cids) == forced


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,on_chip", [(4, 25418, True), (2, 2304, True), (5, 8193, True), (2, 783360, True),
                                         (4, 783360, False), (1024, 4099, False)])
def test_cuda_ingest_chain_plan(cuda_device, c, n, on_chip):
    """Rows go on chip when every (chunk, four-row tile) item gets a block of
    its own: one block an item, each with its rows, anchors and two upload
    buffers (a chunk each) in dynamic shared memory; else the grid is at most
    the blocks that fit at once, with none. On an H100 (132 SMs) four rows on
    chip fit one block an SM, two rows two."""
    from repro_torch.kernels.ingest_chain import chain_plan

    items = -(-n // 4096) * -(-c // 4)
    plan = chain_plan(c, n, cuda_device)
    assert plan["on_chip"] == on_chip, plan
    assert chain_plan(c, n, cuda_device, with_stats=True) == plan  # the norm's instantiation launches alike
    if on_chip:
        assert plan["blocks"] == items and plan["smem"] == (2 * min(c, 4) + 2) * 4096 * 4, plan
    else:
        assert 0 < plan["blocks"] <= items and plan["smem"] == 0, plan


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAIN_SHAPES, ids=str)
def test_cuda_ingest_chain_is_one_kernel_per_call(cuda_device, shape):
    """A call runs one ``ingest_chain_kernel`` on the device and no other
    kernel and no device-to-device copy (the carried matrix is the kernel's
    own output, not a clone of the centers); the one host-to-device copy is
    the index table. The profiler can lose kernels of a short session (never
    add any); one session must show every launch."""
    s, c, n = shape
    U, centers, bcast, prev, forced = _chain_inputs(s, c, n)
    args = [torch.from_numpy(a).to(cuda_device) for a in (U, centers, bcast)]
    calls, full = 4, False
    for _ in range(5):
        names = _traced_kernels(lambda: [ops.ingest_chain(*args, prev, forced, beta=0.25) for _ in range(calls)])
        chains = [k for k in names if "ingest_chain_kernel" in k]
        others = [k for k in names if k not in chains and "HtoD" not in k]
        assert len(chains) <= calls and not others, names
        if len(chains) == calls:
            full = True
            break
    assert full, "no profiler session recorded every chain launch"


@pytest.mark.cuda
def test_cuda_l1_vec_is_the_chain_order(cuda_device):
    """On the card ``l1_vec`` is one ``l1_distance`` launch: the bits of the
    numpy model of the L1 order, which the chain's statistics share."""
    from test_torch_l1_order import kernel_l1

    from repro_torch.core.plane import l1_vec

    rng = np.random.default_rng(3)
    for n in (1, 4099, 25418):
        a, b = _f32(rng, n), _f32(rng, n)
        ops.reset_launch_counts()
        got = l1_vec(torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device))
        assert ops.launch_counts()["l1_distance"] == 1
        assert got.cpu().numpy().tobytes() == kernel_l1(a, b).tobytes()


def _har_baseline_run(name: str, device, **kw):
    from repro_torch.configs.paper_tasks import PAPER_TASKS
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.models.mlp import init_mlp

    init = init_mlp(PAPER_TASKS["har"], torch.Generator().manual_seed(0))
    init_np = [{k: v.numpy() for k, v in layer.items()} for layer in init]
    return run_experiment("har", name, num_clients=8, seed=0, device=device, init_params=init_np, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("fedavg", dict(rounds=5)), ("fedasyn", dict(max_time=900)),
                                     ("fedasyn", dict(max_time=900, coalesce_window=45.0))], ids=str)
def test_cuda_har_baseline_matches_the_cpu(cuda_device, name, kw):
    """A ``har`` baseline run on the card against the same run on the CPU:
    identical ledgers and stats, accuracy curves within 0.02; an MLP
    baseline launches none of the port's kernels."""
    _, _, sc, rc = _har_baseline_run(name, "cpu", **kw)
    ops.reset_launch_counts()
    _, _, sg, rg = _har_baseline_run(name, cuda_device, **kw)
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    for field in ("up_events", "down_events", "up_bytes", "down_bytes", "duration", "up_series", "down_series"):
        assert getattr(rc, field) == getattr(rg, field), field
    assert sc.stats() == sg.stats() and rc.summary()["total_MB"] == rg.summary()["total_MB"]
    assert [t for t, _ in rc.curve] == [t for t, _ in rg.curve]
    np.testing.assert_allclose([a for _, a in rg.curve], [a for _, a in rc.curve], atol=0.02, rtol=0)
    assert sg._vec.device.type == "cuda" and bool(torch.isfinite(sg._vec).all())


# the uplink encodes: (B, n, chunk, k) at the paths' widths (har, image_recognition, tiny_lm, the
# full-width delta) with k = round(0.1 n), B = 1, 3, 32; then n = 1, n % chunk = 1 and k = n; then
# about the top-k split's edges: a row too short to split, split rows, more rows than the card holds split
UPLINK_SHAPES = [(b, n, 512, round(0.1 * n)) for n in (4550, 25418, 2304, 783360) for b in (1, 3, 32)] + [
    (2, 1, 1, 1), (3, 513, 512, 51), (2, 4097, 4096, 4097),
    (1, 8191, 512, 819), (3, 8192, 512, 819), (600, 8192, 512, 819)]


def _encode_case(kind, shape, device):
    from test_torch_uplink import encode_inputs, encode_plane

    b, n, chunk, k = shape
    A, R, mat = encode_inputs(kind, b, n, b * n + k)
    plane, a_rows, r_rows = encode_plane(A, R, b)
    return [t.to(device) for t in (plane, a_rows, r_rows, torch.from_numpy(mat))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "nan", "inf"])
@pytest.mark.parametrize("shape", UPLINK_SHAPES, ids=str)
def test_cuda_uplink_encodes_are_the_plain_versions_bit_for_bit(cuda_device, kind, shape):
    """Each encode kernel against its plain version on the same card inputs:
    the reconstruction and the whole plane after the call (the anchor and
    residual rows it writes, the rows it must not touch) with NaN at the
    same places and every other element bitwise; the trained rows only
    read; the same bits over 3 repeats from the same plane."""
    from repro_torch.kernels import uplink

    _, _, chunk, k = shape
    plane, a_rows, r_rows, mat = _encode_case(kind, shape, cuda_device)
    mat0 = mat.clone()
    cases = (("int8", lambda p: uplink.uplink_int8_encode(p, a_rows, mat, chunk),
              lambda p: uplink.uplink_int8_encode_plain(p, a_rows, mat, chunk)),
             ("topk", lambda p: uplink.uplink_topk_encode(p, a_rows, r_rows, mat, k),
              lambda p: uplink.uplink_topk_encode_plain(p, a_rows, r_rows, mat, k)))
    for name, kernel, plain in cases:
        want_plane = plane.clone()
        want = plain(want_plane)
        for _ in range(3):
            got_plane = plane.clone()
            got = kernel(got_plane)
            torch.cuda.synchronize()
            assert _same_nan_bits(got, want), f"{name}: reconstruction"
            assert _same_nan_bits(got_plane, want_plane), f"{name}: plane rows"
        assert _same_nan_bits(mat, mat0), f"{name}: the trained rows were written"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 25418, 512, 2542), (3, 4550, 512, 455), (1, 783360, 512, 78336)], ids=str)
def test_cuda_uplink_encodes_are_one_launch_per_call(cuda_device, shape):
    from repro_torch.kernels import uplink

    _, _, chunk, k = shape
    plane, a_rows, r_rows, mat = _encode_case("random", shape, cuda_device)
    topk = "uplink_topk_split_kernel" if uplink.topk_plan(*shape[:2], cuda_device)["parts"] else "uplink_topk_kernel"
    for kernel, fn in (("uplink_int8_kernel", lambda: ops.uplink_int8_encode(plane, a_rows, mat, chunk)),
                       (topk, lambda: ops.uplink_topk_encode(plane, a_rows, r_rows, mat, k))):
        ops.reset_launch_counts()
        fn()
        counts = ops.launch_counts()
        assert counts["uplink_int8_encode"] + counts["uplink_topk_encode"] == 1
        assert uplink.uplink_int8_encode.launches + uplink.uplink_topk_encode.launches == 1
        calls, full = 10, False
        for _ in range(5):
            names = _traced_kernels(lambda: [fn() for _ in range(calls)])
            assert len(names) <= calls and all(kernel in x for x in names), names
            if len(names) == calls:
                full = True
                break
        assert full, f"no profiler session recorded every {kernel}"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["topk", "int8"])
def test_cuda_codec_launches_its_kernel_once_a_cohort(cuda_device, mode):
    """The codec on the card: one kernel launch a cohort, whatever B, and
    its reconstructions those of the same codec on the CPU."""
    from repro_torch.fl.uplink import UplinkCodec, UplinkConfig

    rng = np.random.default_rng(3)
    template = {"w": _f32(rng, 40, 30), "b": _f32(rng, 30)}
    codecs = {dev: UplinkCodec({k: torch.from_numpy(v).to(dev) for k, v in template.items()}, list(range(6)),
                               UplinkConfig(mode=mode, chunk=64), device=dev) for dev in ("cpu", cuda_device)}
    for dev, codec in codecs.items():
        codec.seed({c: {k: torch.from_numpy(v).to(dev) for k, v in template.items()} for c in range(6)})
    ops.reset_launch_counts()
    for cohort in ([0], [1, 2, 3], [4, 5, 0]):
        mat = _f32(rng, len(cohort), codecs["cpu"].dim)
        got = codecs[cuda_device].encode_vecs(cohort, torch.from_numpy(mat).to(cuda_device))
        want = codecs["cpu"].encode_vecs(cohort, torch.from_numpy(mat))
        assert torch.equal(_bits(got.cpu()), _bits(want))
    assert codecs[cuda_device].launches == 3 == ops.launch_counts()[f"uplink_{mode}_encode"]


@pytest.fixture(scope="module")
def cpu_rnn():
    """The broadcast RNN pretrained on the CPU, for the card tests that run
    EchoPFL; a module fixture is set up before ``cuda_device``, so it skips
    by itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.core.broadcast import pretrain_rnn

    return {k: v.numpy() for k, v in pretrain_rnn(0, device="cpu").items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("echopfl", dict(max_time=900, uplink="topk")),
                                     ("echopfl", dict(max_time=900, uplink="int8", coalesce_window=45.0)),
                                     ("fedavg", dict(rounds=5, uplink="int8"))], ids=str)
def test_cuda_har_compressed_matches_the_cpu(cuda_device, cpu_rnn, name, kw):
    """A compressed ``har`` run on the card against the same run on the
    CPU: identical ledgers, stats and decisions, accuracy curves within
    0.02; the codec's kernel launched exactly ``codec.launches`` times."""
    extra = dict(rnn_params=cpu_rnn) if name == "echopfl" else {}
    _, _, sc, rc = _har_baseline_run(name, "cpu", **kw, **extra)
    ops.reset_launch_counts()
    _, _, sg, rg = _har_baseline_run(name, cuda_device, **kw, **extra)
    mode = kw["uplink"]
    assert ops.launch_counts()[f"uplink_{mode}_encode"] == rg.extra["uplink"]["launches"] > 0
    for field in ("up_events", "down_events", "up_bytes", "down_bytes", "up_raw_bytes", "duration", "up_series",
                  "down_series"):
        assert getattr(rc, field) == getattr(rg, field), field
    assert rc.extra["uplink"] == rg.extra["uplink"] and rc.summary()["total_MB"] == rg.summary()["total_MB"]
    if name == "echopfl":
        assert sc.events == sg.events and sc.clustering.assignment == sg.clustering.assignment
    else:
        assert sc.stats() == sg.stats()
    assert [t for t, _ in rc.curve] == [t for t, _ in rg.curve]
    np.testing.assert_allclose([a for _, a in rg.curve], [a for _, a in rc.curve], atol=0.02, rtol=0)


@pytest.mark.cuda
def test_cuda_decode_matches_the_full_forward(cuda_device):
    """Reduced gemma2 on the card (the flash forward at head width 16,
    window 16, softcap 50): prefill, 24 greedy decode steps past the window,
    each step's logits against a teacher-forced full forward within 1e-4;
    one flash forward launch per layer in the prefill, none in the decode."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import decode, prefill
    from repro_torch.models.model import forward, init_params

    cfg = reduced_config(get_config("gemma2-2b"))
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))).to(cuda_device)
    ops.reset_launch_counts()
    logits, cache = prefill(cfg, params, prompts, 24)
    assert ops.launch_counts()["flash_attention_fwd"] == cfg.num_layers
    toks, steps = decode(cfg, params, cache, logits, 24, keep_logits=True)
    assert ops.launch_counts()["flash_attention_fwd"] == cfg.num_layers
    with torch.no_grad():
        full = forward(cfg, params, {"tokens": torch.cat([prompts, toks], dim=1)}, last=25)[0]
    torch.testing.assert_close(logits[:, 0], full[:, 0], rtol=0, atol=1e-4)
    for i, step in enumerate(steps):
        torch.testing.assert_close(step, full[:, i + 1], rtol=0, atol=1e-4, msg=f"step {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "jamba-1.5-large-398b"])
def test_cuda_zoo_decode_matches_the_full_forward(cuda_device, name):
    """Reduced deepseek-v2-lite (MLA through the flash forward at head width
    16 and value width 8; absorbed MLA decode; MoE with shared experts) and
    reduced jamba (Mamba, MoE, one attention layer a period), both MoE
    dropless, on the card: prefill, 12 greedy decode steps, each step's
    logits against a teacher-forced full forward within 1e-4; one flash
    forward launch an attention layer in the prefill, none in the decode."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import decode, prefill
    from repro_torch.models.model import forward, init_params

    cfg = dataclasses.replace(reduced_config(get_config(name)), moe_dropless=True)
    n_attn = sum(spec.mixer in ("attn", "attn_local") for spec in cfg.all_layers)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))).to(cuda_device)
    ops.reset_launch_counts()
    logits, cache = prefill(cfg, params, prompts, 12)
    assert ops.launch_counts()["flash_attention_fwd"] == n_attn > 0
    toks, steps = decode(cfg, params, cache, logits, 12, keep_logits=True)
    assert ops.launch_counts()["flash_attention_fwd"] == n_attn
    with torch.no_grad():
        full = forward(cfg, params, {"tokens": torch.cat([prompts, toks], dim=1)}, last=13)[0]
    torch.testing.assert_close(logits[:, 0], full[:, 0], rtol=0, atol=1e-4)
    for i, step in enumerate(steps):
        torch.testing.assert_close(step, full[:, i + 1], rtol=0, atol=1e-4, msg=f"step {i}")


@pytest.mark.cuda
def test_cuda_encoder_forward_matches_the_cpu(cuda_device):
    """Reduced hubert-xlarge (non-causal attention through the flash forward
    at head width 16, frame embeddings with sinusoidal positions): the
    card's logits against the CPU's within 1e-4, weights from one CPU
    generator; one flash forward launch a layer."""
    from repro_torch.common.pytrees import tree_map
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.model import forward, init_params

    cfg = reduced_config(get_config("hubert-xlarge"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    embeds = torch.from_numpy(_f32(np.random.default_rng(1), 2, 40, cfg.d_model))
    with torch.no_grad():
        want = forward(cfg, params, {"embeds": embeds})[0]
        ops.reset_launch_counts()
        got = forward(cfg, tree_map(lambda t: t.to(cuda_device), params), {"embeds": embeds.to(cuda_device)})[0]
    assert ops.launch_counts()["flash_attention_fwd"] == cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_pytree_assign_is_one_l1_launch(cuda_device):
    """The pytree backend's assign flattens the upload and the centers for
    one ``l1_distance`` launch; the plane backend's is one fused assign."""
    from repro_torch.core.clustering import DynamicClustering

    rng = np.random.default_rng(0)

    def tree():
        return [{"w": torch.from_numpy(_f32(rng, 64, 32)).to(cuda_device),
                 "b": torch.from_numpy(_f32(rng, 32)).to(cuda_device)}]

    cl = DynamicClustering(3, backend="pytree", device=cuda_device)
    for c in range(3):
        cl.assign(c, tree())
    ops.reset_launch_counts()
    cid, created = cl.assign(7, tree())
    counts = ops.launch_counts()
    assert not created and counts["l1_distance"] == 1 and sum(counts.values()) == 1
    cl.aggregate(cid, tree())
    assert sum(ops.launch_counts().values()) == 1 and cl.plane is None


@pytest.mark.cuda
def test_cuda_remat_changes_no_bit(cuda_device):
    """One train step of reduced llama3.2-1b on the card with remat on and
    off: the loss, the metrics and every param and optimizer leaf bit for
    bit; the flash forward launches twice an attention layer with remat (the
    backward recomputes each period), once without, the backward once."""
    import dataclasses

    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.lm import token_stream
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import TrainState, make_optimizer, make_train_step

    base = reduced_config(get_config("llama3.2-1b"))
    batch = next(token_stream(base.vocab_size, seed=0, batch=2, seq=16))
    runs = {}
    for remat in (True, False):
        cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, remat=remat))
        params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
        opt = make_optimizer(cfg)
        state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=cuda_device))
        ops.reset_launch_counts()
        runs[remat] = make_train_step(cfg, opt)(state, batch)
        counts = ops.launch_counts()
        assert counts["flash_attention_fwd"] == (2 if remat else 1) * cfg.num_layers
        assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] == cfg.num_layers
    (a, ma), (b, mb) = runs[True], runs[False]
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.cuda
def test_cuda_trainstate_checkpoint_restores_on_the_cpu(cuda_device, tmp_path):
    """The training driver's ``TrainState`` saved from the card (2 steps,
    a checkpoint at 2) restores on the CPU bit for bit, into the driver's
    NamedTuples, and a CPU run resumes from it."""
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import train as driver
    from repro_torch.models.steps import TrainState

    cfg = reduced_config(get_config("llama3.2-1b"))
    kw = dict(batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=2, verbose=False)
    card = driver.train(cfg, steps=2, device=cuda_device, **kw)
    like = driver.train(cfg, steps=0, device="cpu", batch=2, seq=16, verbose=False)["state"]
    got, extra = restore_pytree(str(tmp_path / "step_0000000002"), like=like)
    assert isinstance(got, TrainState) and extra == {"loss": card["losses"][-1]}
    assert all(np.array_equal(a, b.cpu().numpy()) for a, b in zip(tree_leaves(got), tree_leaves(card["state"])))
    resumed = driver.train(cfg, steps=3, device="cpu", **kw)
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1 and np.isfinite(resumed["losses"][0])


@pytest.mark.cuda
def test_cuda_example_matches_the_cpu(cuda_device, tmp_path):
    """5 rounds of the EchoPFL transformer-client example on the card and
    on the CPU, the same initial weights and broadcast RNN: the same
    arrivals and decisions after every round, round losses within rtol
    1e-4."""
    from repro_torch.core.broadcast import pretrain_rnn
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch import train_async_pfl as example
    from repro_torch.models.model import init_params

    init = tree_to_numpy(init_params(example.example_config(), torch.Generator().manual_seed(0)))
    rnn = {k: v.cpu().numpy() for k, v in pretrain_rnn(0, device=cuda_device).items()}
    runs = {dev: example.run(dev, steps=5, ckpt_dir=str(tmp_path / str(dev)), init_params=init, rnn_params=rnn,
                             verbose=False) for dev in ("cpu", cuda_device)}
    c, g = runs["cpu"], runs[cuda_device]
    assert c["order"] == g["order"] and c["history"] == g["history"]
    assert c["server"].events == g["server"].events
    for cid, want in c["losses"].items():
        np.testing.assert_allclose(g["losses"][cid], want, rtol=1e-4)


MESH_SHAPES = {"1x8": (8, 1), "4x2": (4, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(MESH_SHAPES))
@pytest.mark.parametrize("n", [25418, 4099])  # 4099: no model axis of 2 divides it, rows shard alone
def test_cuda_sharded_ops_match_the_single_device_kernels(cuda_device, shape, n):
    """The four batched plane ops on a mesh that repeats the one card, one
    launch a shard, against the single-device kernels: distances (row
    shards), blends, g and scores bit for bit; dim-sharded distances bit for
    bit the chunks' kernel sums (``kernel_l1``) added in chunk order; segment
    sums within 1 ulp."""
    from test_torch_l1_order import kernel_l1

    from repro_torch.launch.mesh import make_plane_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    rows, dims = MESH_SHAPES[shape]
    mesh = make_plane_mesh(rows, dim_shards=dims, devices=[dev] * (rows * dims))
    shards = rows * dims
    split = dims if n % dims == 0 else 1
    rng = np.random.default_rng(n + rows)
    xs_np, cs_np, u_np = _f32(rng, 11, n), _f32(rng, 5, n), _f32(rng, n)
    xs, cs, u = (torch.from_numpy(a).to(dev) for a in (xs_np, cs_np, u_np))

    def chunk_model(x, c):
        parts = [kernel_l1(a, b) for a, b in zip(np.split(x, split), np.split(c, split))]
        acc = np.float32(parts[0])
        for p in parts[1:]:
            acc = np.float32(acc + p)
        return acc

    ops.reset_launch_counts()
    got = ops.l1_distance_pairwise(xs, cs, mesh=mesh)
    assert ops.launch_counts()["l1_distance_pairwise"] == rows * split
    want = ops.l1_distance_pairwise(xs, cs)
    model = np.asarray([[chunk_model(x, c) for c in cs_np] for x in xs_np], np.float32)
    assert got.cpu().numpy().tobytes() == model.tobytes()
    if split == 1:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)

    ops.reset_launch_counts()
    d, i, b = ops.assign_and_lerp(u, cs, 0.25, mesh=mesh)
    counts = ops.launch_counts()
    assert counts["l1_distance"] == rows * split and counts["assign_and_lerp"] == 0
    ds, is_, bs = ops.assign_and_lerp(u, cs, 0.25)
    assert int(i) == int(is_) and torch.equal(b, bs)
    assert d.cpu().numpy().tobytes() == np.asarray([chunk_model(u_np, c) for c in cs_np], np.float32).tobytes()

    fp, ft, ss = (torch.from_numpy(a).to(dev) for a in _feedback(rng, 13, 10))
    ops.reset_launch_counts()
    g = ops.chi2_feedback(fp, ft, ss, mesh=mesh)
    assert ops.launch_counts()["chi2_feedback"] == shards
    assert torch.equal(g, ops.chi2_feedback(fp, ft, ss))
    seg = torch.from_numpy(np.repeat(np.arange(4), [2, 1, 6, 4]).astype(np.int32)).to(dev)
    g2, s2 = ops.chi2_feedback_segmented(fp, ft, ss, seg, 4, mesh=mesh)
    g1, s1 = ops.chi2_feedback_segmented(fp, ft, ss, seg, 4)
    assert torch.equal(g2, g1)
    np.testing.assert_array_max_ulp(s2.cpu().numpy(), s1.cpu().numpy(), maxulp=1)


# ------------------------------------------------------ bf16 instantiations
def _bf16_rows(rng, *shape, dev):
    return torch.from_numpy(_f32(rng, *shape)).to(dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [25418, 4099, 783360])
def test_cuda_bf16_server_kernels_match_plain(cuda_device, n):
    """Each server kernel's bf16 instantiation against its plain version at
    the tolerances ``chip_smoke.py`` phase 5 states (L1 rtol 3e-3, the
    assign's index equal and blend bitwise, chi2 rtol 1e-5, the merge
    bitwise), and against the fp32 kernel on the rows cast to fp32: the same
    bits, since it is that kernel on converted loads. One launch a call,
    counted in ``.launches_bf16``."""
    rng = np.random.default_rng(n + 1)
    dev = cuda_device
    cs, u, xs = _bf16_rows(rng, 5, n, dev=dev), _bf16_rows(rng, n, dev=dev), _bf16_rows(rng, 8, n, dev=dev)
    f = lambda t: t.float()  # noqa: E731
    before = {k: getattr(w, "launches_bf16", 0) for k, w in ops.WRAPPERS.items()}
    d, i, b = ops.assign_and_lerp(u, cs, 0.25)
    dp, ip, bp = assign_lerp.assign_and_lerp_plain(u, cs, 0.25)
    torch.testing.assert_close(d, dp, rtol=3e-3, atol=0)
    assert int(i) == int(ip) and torch.equal(b, bp)
    d32, i32, b32 = ops.assign_and_lerp(f(u), f(cs), 0.25)
    assert torch.equal(d, d32) and int(i) == int(i32) and torch.equal(b, b32)
    got = ops.l1_distance_pairwise(xs, cs)
    torch.testing.assert_close(got, l1.l1_distance_pairwise_plain(xs, cs), rtol=3e-3, atol=0)
    assert torch.equal(got, ops.l1_distance_pairwise(f(xs), f(cs)))
    assert torch.equal(ops.l1_distance(u, cs), ops.l1_distance(f(u), f(cs)))
    merged = ops.merge_attention(u, cs[0], cs[1])
    assert merged.dtype == torch.bfloat16
    assert torch.equal(merged.view(torch.int16), merge.merge_attention_plain(u, cs[0], cs[1])[0].view(torch.int16))
    fp, ft, ss = (torch.from_numpy(a).to(dev).to(torch.bfloat16) for a in _feedback(rng, 64, 10))
    seg = torch.from_numpy(np.arange(64, dtype=np.int32) % 4).to(dev)
    g, s = ops.chi2_feedback_segmented(fp, ft, ss, seg, 4)
    gp, sp = chi2.chi2_feedback_segmented_plain(fp, ft, ss, seg, 4)
    torch.testing.assert_close(g, gp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=1e-5)
    g32, s32 = ops.chi2_feedback_segmented(f(fp), f(ft), f(ss), seg, 4)
    assert torch.equal(g, g32) and torch.equal(s, s32)
    after = {k: getattr(w, "launches_bf16", 0) for k, w in ops.WRAPPERS.items()}
    for name in ("assign_and_lerp", "l1_distance_pairwise", "l1_distance", "merge_attention",
                 "chi2_feedback_segmented"):
        assert after[name] - before[name] == 1, name


# B, H, KV, Sq, Sk, hd, dv, options: a shape a head-width bucket (16, 32, 64, 128, 256), ragged Sq, a window, a
# softcap, GQA, Sq < Sk with q_pos0, dv != hd, hd 192 (MLA's q/k width: bucket 256 with a zero-filled fourth panel
# on q and k), no causal mask, hd % 8 != 0 (the per-element copies) and phase 5's bf16 step's shape
BF16_FLASH_CASES = [
    (2, 4, 2, 128, 128, 16, 16, {}),
    (2, 4, 2, 128, 128, 32, 32, {}),
    (2, 8, 2, 256, 256, 64, 64, {}),
    (1, 4, 2, 192, 192, 128, 128, {}),
    (1, 4, 2, 160, 160, 256, 256, {}),
    (1, 4, 4, 100, 100, 80, 80, dict(window=32)),
    (1, 8, 4, 100, 100, 64, 48, dict(window=32, softcap=30.0)),
    (1, 8, 2, 96, 96, 256, 192, dict(softcap=50.0)),
    (2, 8, 2, 48, 200, 64, 64, dict(q_pos0=152)),
    (1, 2, 1, 64, 64, 192, 192, {}),
    (1, 2, 1, 64, 192, 128, 128, dict(causal=False)),
    (2, 4, 2, 70, 70, 12, 12, {}),
    (2, 32, 8, 512, 512, 64, 64, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_FLASH_CASES, ids=str)
def test_cuda_bf16_flash_matches_plain(cuda_device, case):
    """The bf16 flash kernels (wgmma, p and ds in two bf16 parts) against
    their plain versions on the same bf16 inputs, at the bounds of
    ``tests/torch_bf16_bounds.py``: o, dq, dk and dv within one bf16 ulp of
    the plain value or 1e-5 absolute (each side rounds an fp32 value to bf16
    once, and the fp32 values differ by a few 1e-6: the sums' order and the
    split's dropped term, about 2^-17 of a product; the CPU emulation of the
    kernels' arithmetic, ``tests/test_torch_flash_bf16_mma.py``, shows both
    and that 1e-6 and atol = rtol = 4e-3 are too tight at phase 5's shape),
    lse within atol = rtol = 1e-5 (fp32 on both sides), and every output
    within the reference's 2e-2; o and the gradients bf16, lse fp32, the
    backward bitwise across repeats. hd % 8 != 0 takes the per-element
    copies, every other case the 16-byte cp.async."""
    from torch_bf16_bounds import LSE_TOL, REFERENCE_TOL, within_one_ulp

    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import flash_attention_bwd as FB

    B, H, KV, Sq, Sk, hd, dv, kw = case
    rng = np.random.default_rng(Sq + hd)
    dev = cuda_device
    q, do = _bf16_rows(rng, B, H, Sq, hd, dev=dev), _bf16_rows(rng, B, H, Sq, dv, dev=dev)
    k, v = _bf16_rows(rng, B, KV, Sk, hd, dev=dev), _bf16_rows(rng, B, KV, Sk, dv, dev=dev)
    assert F.bf16_copy_path(q, k, v, do) == ("per element" if hd % 8 else "cp.async 16 B")
    o, lse = F.flash_attention_with_lse(q, k, v, **kw)
    op, lsep = F.flash_attention_with_lse_plain(q, k, v, **kw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert within_one_ulp(o, op)
    torch.testing.assert_close(lse, lsep, rtol=LSE_TOL, atol=LSE_TOL)
    torch.testing.assert_close(o.float(), op.float(), rtol=REFERENCE_TOL, atol=REFERENCE_TOL)
    got = FB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = FB.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16, name
        assert within_one_ulp(g, w), name
        torch.testing.assert_close(g.float(), w.float(), rtol=REFERENCE_TOL, atol=REFERENCE_TOL)
    again = FB.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_dryrun_state_bytes_equal_the_placed_state(cuda_device):
    """The dry-run's fp32 ``state_bytes_per_device`` of a reduced
    llama3.2-1b train step (unmeshed) against the same ``TrainState`` placed
    on the card: the leaves' bytes equal, and ``torch.cuda.memory_allocated``
    grows by exactly those bytes, each leaf rounded up to the caching
    allocator's 512-byte blocks."""
    from repro_torch.common.pytrees import tree_leaves
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.model import init_params
    from repro_torch.models.steps import TrainState, make_optimizer

    cfg = reduced_config(get_config("llama3.2-1b"))
    rec = dryrun.run_cell(cfg.name, "t", False, None, cfg=cfg, shape=ShapeSpec("t", 64, 4, "train"),
                          mesh=dryrun.meta_mesh((1, 1)), dtype=torch.float32)
    assert rec["status"] == "OK"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    state = TrainState(params, make_optimizer(cfg).init(params), torch.zeros((), dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - before
    leaves = [t.numel() * t.element_size() for t in tree_leaves(state)]
    assert rec["state_bytes_per_device"] == sum(leaves)
    assert placed == sum(-(-n // 512) * 512 for n in leaves)


# ------------------------------------------------------- the broadcast RNN
# chains: (window length k, seed); k = 128 is the largest a path runs (128 clients), past the 12 whose
# histories the kernel keeps in shared memory
RNN_CHAINS = [(10, 0), (16, 1), (33, 2), (128, 3)]


def _rnn_weights(seed, device):
    from repro_torch.core.broadcast import init_rnn

    return init_rnn(torch.Generator().manual_seed(seed), device=device)


def _rnn_same_bits(a, b):
    return all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [10, 128])
def test_cuda_rnn_step_matches_plain(cuda_device, T):
    """One SGD step (each label) within rtol 1e-6, atol 1e-7 of the plain
    step, and 64 decisions identical wherever the plain margin exceeds 1e-5."""
    from repro_torch.kernels import rnn

    rng = np.random.default_rng(T)
    p = _rnn_weights(T, cuda_device)
    for label in (0, 1):
        seq = rng.uniform(0, 1, (T, 1)).astype(np.float32)
        got, loss = rnn.rnn_sgd(p, seq, label, 1e-2)
        want, want_loss = rnn.rnn_sgd_plain(p, torch.from_numpy(seq).to(cuda_device), label, 1e-2)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=k)
        torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    seqs = rng.uniform(0, 1, (64, T, 1)).astype(np.float32)
    got = [bool(rnn.rnn_want(p, x)) for x in seqs]
    margins = [float(np.diff(rnn.rnn_logits(p, torch.from_numpy(x).to(cuda_device)).cpu().numpy())[0]) for x in seqs]
    want = [m > 0 for m in margins]
    under = sum(abs(m) <= 1e-5 for m in margins)
    print(f"T {T}: {under} of 64 probes within the 1e-5 margin")
    assert all(a == b or abs(m) <= 1e-5 for a, b, m in zip(got, want, margins))


@pytest.mark.cuda
@pytest.mark.parametrize("k,seed", RNN_CHAINS, ids=str)
def test_cuda_rnn_chain_matches_plain(cuda_device, k, seed):
    """32 steps with mixed gates and ragged windows: wants identical under
    the margin rule, leaves within rtol 1e-5, atol 1e-6."""
    from repro_torch.kernels import rnn
    from torch_rnn_model import chain_inputs, check_wants, plain_serial

    p = _rnn_weights(seed, cuda_device)
    args = chain_inputs(k, 32, seed)
    got, wants = rnn.rnn_chain(p, *args, 1e-2)
    want, want_wants, margins = plain_serial(p, *args, 1e-2)
    under, split = check_wants(wants.tolist(), want_wants, margins)
    print(f"k {k}: {under} decisions within the margin, first difference at {split}")
    if split is None:
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("k,seed", RNN_CHAINS, ids=str)
def test_cuda_rnn_chain_is_per_event_launches_bit_for_bit(cuda_device, k, seed):
    """A chain is one launch and the same bits as its steps launched one by
    one (a learn, a decision), as ``BroadcastPredictor.learn`` and
    ``decide`` launch them; a launch repeats its bits."""
    from repro_torch.kernels import rnn
    from torch_rnn_model import chain_inputs

    p = _rnn_weights(seed, cuda_device)
    pre, post, lab, fb, learn, decide, fallback = args = chain_inputs(k, 32, seed)
    ops.reset_launch_counts()
    got, wants = rnn.rnn_chain(p, *args, 1e-2)
    assert ops.launch_counts()["rnn_chain"] == 1
    q, fire, serial = p, 0, []
    for s in range(len(learn)):
        if learn[s]:
            q, _ = rnn.rnn_sgd(q, pre[s], int(lab[s, fire]), 1e-2)
        want = bool(fb[s, fire]) if fallback[s] else bool(rnn.rnn_want(q, post[s])) if decide[s] else False
        fire = s + 1 if want else fire
        serial.append(want)
    assert ops.launch_counts()["rnn_chain"] == 1 + int(learn.sum()) + int((decide & ~fallback).sum())
    assert wants.tolist() == serial and _rnn_same_bits(got, q)
    again, wants2 = rnn.rnn_chain(p, *args, 1e-2)
    assert torch.equal(wants, wants2) and _rnn_same_bits(got, again)


@pytest.mark.cuda
def test_cuda_rnn_pretraining_is_one_launch_within_its_bound(cuda_device):
    """``pretrain_rnn``: one launch of 1,200 learn steps, within 4 times the
    fp32-against-fp64 gap of the plain pretraining on the card; twice the
    same bits."""
    from repro_torch.core.broadcast import pretrain_rnn, pretrain_windows
    from repro_torch.kernels import rnn
    from torch_rnn_model import PRETRAIN_BOUND_FACTOR, PRETRAIN_FP32_GAP

    ops.reset_launch_counts()
    got = pretrain_rnn(0, device=cuda_device)
    assert ops.launch_counts()["rnn_chain"] == 1
    windows, labels = pretrain_windows(0)
    learn = np.ones(len(labels), bool)
    want, _ = rnn.rnn_chain_plain(_rnn_weights(0, cuda_device), windows, None, labels, None, learn, ~learn, ~learn,
                                  5e-3)
    gap = max(float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in want)
    print(f"pretraining, kernel against plain on the card: largest relative leaf gap {gap:.3g}")
    assert gap <= PRETRAIN_BOUND_FACTOR * PRETRAIN_FP32_GAP
    assert _rnn_same_bits(got, pretrain_rnn(0, device=cuda_device))


@pytest.mark.cuda
def test_cuda_rnn_window_limit(cuda_device):
    """The longest window (1,024 records) launches; one more raises, with no fallback."""
    from repro_torch.kernels import rnn

    p = _rnn_weights(5, cuda_device)
    x = np.random.default_rng(5).uniform(0, 1, (rnn.MAX_T + 1, 1)).astype(np.float32)
    ops.reset_launch_counts()
    got, _ = rnn.rnn_sgd(p, x[:-1], 1, 1e-2)
    want, _ = rnn.rnn_sgd_plain(p, torch.from_numpy(x[:-1]).to(cuda_device), 1, 1e-2)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=k)
    with pytest.raises(ValueError):
        rnn.rnn_sgd(p, x, 1, 1e-2)
    with pytest.raises(ValueError):
        rnn.rnn_want(p, x)
    assert ops.launch_counts()["rnn_chain"] == 1


@pytest.mark.cuda
def test_cuda_rnn_child_learns_without_touching_its_parent(cuda_device):
    """An expanded cluster's predictor shares its parent's weight tensors;
    its learn launches into fresh leaves and leaves the parent's bits."""
    from repro_torch.core.broadcast import BroadcastPredictor, predictor_for_expansion

    parent = BroadcastPredictor(params=_rnn_weights(6, cuda_device), k=10, records=[0.5, 1.25, 0.75])
    before = {k: v.clone() for k, v in parent.params.items()}
    child = predictor_for_expansion(parent, 2.0)
    child.observe(1.5)
    child.learn(1)
    assert _rnn_same_bits(parent.params, before)
    assert not _rnn_same_bits(child.params, before)
    assert not any(child.params[k].data_ptr() == parent.params[k].data_ptr() for k in before)
