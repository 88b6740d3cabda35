"""The port's MoE, MLA and encoder archs against the reference's, on the
CPU: reduced ``granite-moe-3b-a800m`` (GQA 4:4 here, MoE on every layer,
tied embeddings), ``deepseek-v2-lite-16b`` (MLA, a dense prefix layer, MoE
with 2 shared experts) and ``hubert-xlarge`` (a non-causal encoder on frame
embeddings, no decode). The per-arch checks and their tolerances are
``tests/torch_zoo.py``'s (logits and caches within rtol/atol 1e-4). The
function-level checks here, each within rtol/atol 1e-5 of the reference's
function on the same inputs:

* ``apply_moe_ffn`` at capacity factor 0.5 (pairs dropped), at a group
  size that leaves a ragged tail (zero output), with a zero router (every
  probability tied: experts 0..K-1 must win, in that order), with shared
  experts, dropless, and its gradients;
* MLA's absorbed decode step (``_mla_decode_absorbed``) against
  ``_apply_mla`` with a prepended cache, both packages';
* a deepseek param tree (the ``prefix`` list) through the checkpointer
  into the reference's format and back, bit for bit;
* ``param_count`` and ``active_param_count`` of all 11 full configs equal
  to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo as Z
from repro.checkpoint import checkpointer as jck
from repro.configs import ARCH_REGISTRY as JAX_ARCHS
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.common.pytrees import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs import ARCH_REGISTRY
from repro_torch.models import layers as L
from repro_torch.models import model as M
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-lite-16b", "hubert-xlarge"]
DECODERS = [a for a in ARCHS if a != "hubert-xlarge"]


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_and_aux(name):
    Z.check_forward(name)


@pytest.mark.parametrize("name", ARCHS)
def test_every_layer_on_the_references_input(name):
    Z.check_layers(name)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_caches_and_init_cache(name):
    Z.check_prefill(name)


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("name", DECODERS)
def test_decode_steps_match_the_references_serve_step(name, dropless):
    Z.check_decode_against_reference(name, dropless)


@pytest.mark.parametrize("name", DECODERS)
def test_decode_matches_the_ports_full_forward(name):
    Z.check_decode_against_forward(name)


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("name", ARCHS)
def test_train_steps_match_the_reference(name, steps):
    Z.check_train(name, steps)


@pytest.mark.parametrize("name", ARCHS)
def test_eval_step(name):
    Z.check_eval(name)


def test_the_encoder_has_no_decode_step():
    from repro_torch.launch.serve import serve

    with pytest.raises(SystemExit, match="no decode"):
        serve(Z.weights("hubert-xlarge")[1], batch=1, prompt=4, gen=1, device="cpu")


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_param_counts_equal_the_references(name):
    mine, ref = ARCH_REGISTRY[name], JAX_ARCHS[name]
    assert mine.param_count() == ref.param_count() > 0
    assert mine.active_param_count() == ref.active_param_count() > 0


# ----------------------------------------------------------------- the MoE FFN
def _moe(name="deepseek-v2-lite-16b", **change):
    jcfg, tcfg, jp, tp = Z.weights(name)
    jcfg, tcfg = Z._replace(jcfg, **change), Z._replace(tcfg, **change)
    return jcfg, tcfg, jax.tree_util.tree_map(lambda t: t[0], jp["blocks"]["slot0"]["ffn"]), \
        tree_map(lambda t: t[0], tp["blocks"]["slot0"]["ffn"])


MOE_CASES = {  # arch, config change, parameter change, call options
    "drops": ("granite-moe-3b-a800m", {}, None, dict(capacity_factor=0.5)),
    "ragged tail": ("granite-moe-3b-a800m", {}, None, dict(group_size=10)),
    "tied router": ("granite-moe-3b-a800m", {}, "zero router", dict(capacity_factor=0.5)),
    "shared experts": ("deepseek-v2-lite-16b", {}, None, dict(capacity_factor=0.75, group_size=8)),
    "dropless": ("deepseek-v2-lite-16b", {"moe_dropless": True}, None, dict(group_size=16)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_ffn_matches_the_references(case):
    name, change, param_change, kw = MOE_CASES[case]
    jcfg, tcfg, jffn, tffn = _moe(name, **change)
    if param_change == "zero router":
        jffn = dict(jffn, router=jnp.zeros_like(jffn["router"]))
        tffn = dict(tffn, router=torch.zeros_like(tffn["router"]))
    x = np.random.default_rng(3).standard_normal((2, 13, tcfg.d_model)).astype(np.float32)
    want, want_aux = JL.apply_moe_ffn(jffn, jnp.asarray(x), jcfg, **kw)
    got, aux = L.apply_moe_ffn(tffn, torch.from_numpy(x), tcfg, **kw)
    Z.close(got, want, 1e-5, case)
    Z.close(aux, want_aux, 1e-5, "aux")
    zero_rows = np.all(np.asarray(want) == 0, axis=-1).sum()
    if case == "ragged tail":  # 26 tokens in groups of 10: the last 6 get zero output
        assert zero_rows == 6 and not got.reshape(-1, tcfg.d_model)[-6:].any()
    if case in ("drops", "tied router"):  # some pairs dropped: C = ceil(2 x 26 x 0.5 / 4) = 7 of 13 a tie
        probs = torch.softmax(torch.from_numpy(x).reshape(-1, tcfg.d_model) @ tffn["router"], -1)
        routed = L.top_k(probs, tcfg.moe.top_k)[1]
        per_expert = torch.bincount(routed.reshape(-1), minlength=tcfg.moe.num_experts)
        assert per_expert.max() > 7
        if case == "tied router":
            assert torch.equal(routed, torch.tensor([[0, 1]]).expand_as(routed))


def test_moe_gradients_match_the_references():
    """The gradient of a scalar of the output and the aux loss in every
    leaf and in the input, with drops (capacity factor 0.5)."""
    jcfg, tcfg, jffn, tffn = _moe("deepseek-v2-lite-16b")
    x = np.random.default_rng(4).standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((2, 9, tcfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        y, aux = JL.apply_moe_ffn(p, xx, jcfg, capacity_factor=0.5)
        return jnp.sum(y * w) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jffn, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tffn)]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = L.apply_moe_ffn(tree_unflatten(tffn, leaves), xt, tcfg, capacity_factor=0.5)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [*leaves, xt])
    for a, b in zip(grads[:-1], jax.tree_util.tree_leaves(jg)):
        Z.close(a, b, 1e-5, "param grad")
    Z.close(grads[-1], jgx, 1e-5, "input grad")


def test_top_k_breaks_ties_like_lax_top_k():
    p = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.2, 0.3, 0.2]])
    values, indices = L.top_k(p, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 3)
    assert indices.tolist() == np.asarray(ji).tolist() == [[0, 1, 2], [1, 3, 0], [0, 2, 1]]
    assert np.array_equal(values.numpy(), np.asarray(jv))


# --------------------------------------------------------------------- MLA
def test_mla_absorbed_decode_matches_apply_mla_with_a_cache():
    """A cache of 10 latent positions, then one token at position 10:
    ``_mla_decode_absorbed`` against ``_apply_mla`` over the concatenated
    cache, the port's and the reference's; the buffers written in place at
    position 10 with the new entries."""
    jcfg, tcfg, jp, tp = Z.weights("deepseek-v2-lite-16b")
    jmix, tmix = jp["prefix"][0]["mixer"], tp["prefix"][0]["mixer"]
    m = tcfg.mla
    rng = np.random.default_rng(8)
    ckv = rng.standard_normal((2, 10, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((2, 10, m.qk_rope_head_dim)).astype(np.float32)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    want, wnew = JL._apply_mla(jmix, jnp.asarray(x), jcfg, cache={"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope)},
                               pos0=10, return_cache=True)
    got, gnew = L._apply_mla(tmix, torch.from_numpy(x), tcfg, cache={"ckv": torch.from_numpy(ckv),
                                                                        "krope": torch.from_numpy(krope)},
                             pos0=10, return_cache=True)
    Z.close(got, want, 1e-5, "_apply_mla")
    buf = {"ckv": torch.zeros((2, 16, m.kv_lora_rank)), "krope": torch.zeros((2, 16, m.qk_rope_head_dim))}
    buf["ckv"][:, :10], buf["krope"][:, :10] = torch.from_numpy(ckv), torch.from_numpy(krope)
    jbuf = {k: jnp.asarray(v.numpy()) for k, v in buf.items()}
    absorbed, out_buf = M._mla_decode_absorbed(tmix, torch.from_numpy(x), tcfg, buf, 10)
    jabsorbed, jout_buf = JM._mla_decode_absorbed(jmix, jnp.asarray(x), jcfg, jbuf, 10)
    Z.close(absorbed, want, 1e-5, "absorbed against _apply_mla")
    Z.close(absorbed, jabsorbed, 1e-5, "absorbed against the reference's")
    for k in ("ckv", "krope"):
        assert out_buf[k] is buf[k]
        Z.close(buf[k][:, 10:11], wnew[k], 1e-5, k)
        Z.close(buf[k], jout_buf[k], 1e-5, k)
        assert not buf[k][:, 11:].any()


# -------------------------------------------------------------- checkpoints
def test_deepseek_params_through_the_checkpointer(tmp_path):
    """The reduced deepseek tree (a ``prefix`` list beside the stacked
    ``blocks``) saved by the port reads back in the reference's checkpointer
    with the reference's paths, and the reference's file reads back in the
    port, bit for bit."""
    _, tcfg, jp, _ = Z.weights("deepseek-v2-lite-16b")
    tp = M.init_params(tcfg, torch.Generator().manual_seed(0))
    assert isinstance(tp["prefix"], list) and len(tp["prefix"]) == 1
    save_pytree(str(tmp_path / "port"), tp)
    like = jax.tree_util.tree_map(np.asarray, jp)
    got, _ = jck.restore_pytree(str(tmp_path / "port"), like=like)
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(like)[0]]
    assert "['prefix'][0]['mixer']['w_ukv']" in paths
    assert jck._paths_and_leaves(got)[0] == paths
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(got)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    jck.save_pytree(str(tmp_path / "ref"), like)
    back, _ = restore_pytree(str(tmp_path / "ref"), like=tp)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(like)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert [tuple(t.shape) for t in tree_leaves(back)] == [t.shape for t in jax.tree_util.tree_leaves(like)]


def test_init_params_matches_the_references_layout():
    """The port's own random init has the reference's tree: keys, shapes,
    the fp32 router, the constant leaves (norms zero)."""
    for name in ARCHS:
        _, tcfg, jp, _ = Z.weights(name)
        tp = M.init_params(tcfg, torch.Generator().manual_seed(0))
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        tflat = tree_leaves(tp)
        assert len(jflat) == len(tflat)
        for (path, want), got in zip(jflat, tflat):
            assert tuple(got.shape) == want.shape, (name, jax.tree_util.keystr(path))
            if "norm" in jax.tree_util.keystr(path):
                assert not got.any()
