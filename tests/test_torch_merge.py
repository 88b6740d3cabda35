"""The merge (paper Algorithm 1, lines 2-6) against the reference, on the CPU.

``kernels/merge.py::merge_attention_plain`` takes every step of the
reference's eager ``ref.merge_attention_ref`` as one rounded fp32
operation, so the two agree bit for bit: on random rows at every width, and
on NaN in any input, on +-inf, on all-negative agreement and on signed
zeros (NaN positions equal, every other element bitwise). The maxima
propagate NaN, as ``jnp.max`` and ``jnp.maximum`` do, and relu(-0) is +0.
The CUDA kernel (``csrc/merge.cu``) is held to the plain version bit for bit
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2), on
the cases of :func:`merge_cases`.

The reference's jitted paths (``repro.kernels.ops.merge_attention`` and the
Pallas kernel in interpret mode) agree within rtol 1e-6 / atol 1e-6, because
XLA contracts their blend into an FMA (ROADMAP queue 3):
``tests/test_torch_kernels.py::test_merge_attention_matches_pallas``.

``DynamicClustering.merge_pair`` merges the plane rows in place: it reads
neither ``plane.row`` nor ``plane.write``, and ends where the copying path
ended. JAX is imported only inside the tests that use it: the card tests
import this module on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.clustering import DynamicClustering
from repro_torch.kernels import merge, ops
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

WIDTHS = (1, 100, 4550, 25418, 70000)
CASES = ("random", "nan in v_main", "nan in v_aux", "nan in v_trained", "+inf", "-inf", "all-negative p",
         "signed zeros")


def merge_cases(rng, n: int) -> dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(v_main, v_aux, v_trained) fp32 rows of length n, by case: random;
    a NaN in one input; +inf in v_aux, -inf in v_trained; agreement p < 0
    everywhere (the normalizer is then 1e-12 and alpha 0); and p = -0 where
    v_main = -0, v_aux = +0, v_trained = -1, where relu(-0) = +0 decides the
    sign of the merged zero."""
    vm, va, vt = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    out = {"random": (vm, va, vt)}
    for label, which, at in (("nan in v_main", 0, n // 2), ("nan in v_aux", 1, n // 3),
                             ("nan in v_trained", 2, n - 1)):
        rows = [vm.copy(), va.copy(), vt.copy()]
        rows[which][at] = np.nan
        out[label] = tuple(rows)
    a = va.copy()
    a[n // 2] = np.inf
    out["+inf"] = (vm, a, vt)
    t = vt.copy()
    t[n // 3] = -np.inf
    out["-inf"] = (vm, va, t)
    out["all-negative p"] = (vm, vm + np.float32(1), vm - np.float32(1))
    m, a, t = vm.copy(), va.copy(), vt.copy()
    m[::7], a[::7], t[::7] = -0.0, 0.0, -1.0
    out["signed zeros"] = (m, a, t)
    return out


def same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    """NaN at the same places and every other element bitwise equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan)
                and np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reference(vm, va, vt):
    import jax.numpy as jnp

    from repro.kernels import ref

    merged, alpha = ref.merge_attention_ref(jnp.asarray(vm), jnp.asarray(va), jnp.asarray(vt))
    return np.asarray(merged), np.asarray(alpha)


@pytest.mark.parametrize("n", WIDTHS)
def test_plain_is_the_eager_reference_bit_for_bit(n):
    vm, va, vt = merge_cases(np.random.default_rng(n), n)["random"]
    merged, alpha = merge.merge_attention_plain(_t(vm), _t(va), _t(vt))
    want_merged, want_alpha = _reference(vm, va, vt)
    np.testing.assert_array_equal(merged.numpy().view(np.int32), want_merged.view(np.int32))
    np.testing.assert_array_equal(alpha.numpy().view(np.int32), want_alpha.view(np.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", (1, 100, 4099))
def test_edge_cases_give_the_reference_output(case, n):
    vm, va, vt = merge_cases(np.random.default_rng(7 * n), n)[case]
    got = merge.merge_attention(_t(vm), _t(va), _t(vt)).numpy()
    want = _reference(vm, va, vt)[0]
    assert same_bits(got, want), case
    if case.startswith("nan"):
        assert np.isnan(got).all(), "a NaN in p makes every output NaN"
    if case == "all-negative p":
        np.testing.assert_array_equal(got.view(np.int32), vm.view(np.int32))


def test_signed_zero_merges_to_plus_zero_as_the_reference():
    vm, va, vt = (np.asarray(x, np.float32) for x in ([-0.0, 1.0], [0.0, 3.0], [-1.0, 2.0]))
    got = merge.merge_attention(_t(vm), _t(va), _t(vt)).numpy()
    assert not np.signbit(got[0]) and not np.signbit(_reference(vm, va, vt)[0][0])


@pytest.mark.parametrize("n", (1, 4550))
def test_out_v_main_gives_the_bits_of_a_fresh_output(n):
    vm, va, vt = merge_cases(np.random.default_rng(n), n)["random"]
    fresh = merge.merge_attention(_t(vm), _t(va), _t(vt))
    m = _t(vm.copy())
    got = merge.merge_attention(m, _t(va), _t(vt), out=m)
    assert got is m
    assert torch.equal(m.view(torch.int32), fresh.view(torch.int32))


@pytest.mark.parametrize("other", ("v_aux", "v_trained", "a copy of v_main", "a fresh tensor"))
def test_out_must_be_v_main_itself(other):
    vm, va, vt = (_t(x) for x in merge_cases(np.random.default_rng(0), 64)["random"])
    out = {"v_aux": va, "v_trained": vt, "a copy of v_main": vm.clone(), "a fresh tensor": torch.empty(64)}[other]
    with pytest.raises(ValueError, match="out must be v_main"):
        ops.merge_attention(vm, va, vt, out=out)


# ------------------------------------------------------------- merge_pair
def _tree(rng):
    return [{"w": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}]


def _train(tree):
    return [{k: v * 0.9 + 0.01 for k, v in layer.items()} for layer in tree]


def _clustering(seed):
    """Two clusters fed from one seed, after eight uploads of four
    clients."""
    rng = np.random.default_rng(seed)
    dc = DynamicClustering(2, mix_rate=0.25, hm=1.0)
    for client in ("a", "b", "c", "d", "a", "b", "c", "d"):
        up = _tree(rng)
        cid, _ = dc.assign(client, up)
        dc.aggregate(cid, up)
    return dc


def _copying_merge_pair(dc, cid_a, cid_b, local_train_fn):
    """The merge as the port ran it before it merged in place: clone both
    rows, merge into a fresh vector, write it back."""
    a, b = dc.clusters[cid_a], dc.clusters[cid_b]
    main, aux = (a, b) if a.size >= b.size else (b, a)
    v_m, v_aux = dc.plane.row(main._row), dc.plane.row(aux._row)
    v_trained = dc.plane.from_pytree(local_train_fn(main.center))
    main.set_center_vec(ops.merge_attention(v_m, v_aux, v_trained))
    main.version += 1
    for client in list(aux.members):
        dc._move(client, main.cluster_id)
    main.partial_finetune.clear()
    dc.drop_cluster(aux.cluster_id)
    dc.merges += 1
    return main.cluster_id


def test_merge_pair_merges_in_place_as_the_copying_path(monkeypatch):
    """No ``plane.row`` and no ``plane.write`` in ``merge_pair`` (the one copy
    left is the center tree handed to ``local_train_fn``, as in the
    reference); the merged row, the members, the assignment and the counts
    equal those of the copying path from the same inputs."""
    new, old = _clustering(3), _clustering(3)
    assert sorted(new.clusters) == [0, 1] and new.clusters[0].size != new.clusters[1].size

    def refuse(*_a, **_k):
        raise AssertionError("merge_pair copied a plane row")

    monkeypatch.setattr(new.plane, "row", refuse)
    monkeypatch.setattr(new.plane, "write", refuse)
    main_row = max(new.clusters.values(), key=lambda c: c.size)._row
    kept = new.merge_pair(0, 1, _train)
    monkeypatch.undo()
    assert kept == _copying_merge_pair(old, 0, 1, _train)
    assert torch.equal(new.plane.row(main_row).view(torch.int32),
                       old.clusters[kept].center_vec.view(torch.int32))
    for attr in ("assignment", "merges"):
        assert getattr(new, attr) == getattr(old, attr)
    assert sorted(new.clusters) == sorted(old.clusters) == [kept]
    c_new, c_old = new.clusters[kept], old.clusters[kept]
    assert (c_new.members, c_new.version, c_new.partial_finetune) == (c_old.members, c_old.version, c_old.partial_finetune)
    assert new.plane.num_allocated == old.plane.num_allocated
    for x, y in zip(c_new.center[0].values(), c_old.center[0].values()):  # the cache was dropped
        assert torch.equal(x, y)


def test_merge_pair_trains_on_the_pre_merge_center():
    dc = _clustering(5)
    main = max(dc.clusters.values(), key=lambda c: c.size)
    before = dc.plane.row(main._row)
    seen = []
    dc.merge_pair(0, 1, lambda tree: seen.append(dc.plane.from_pytree(tree)) or _train(tree))
    assert torch.equal(seen[0], before)
    assert not torch.equal(dc.plane.row(main._row), before)
