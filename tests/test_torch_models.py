"""The port's dense decoders against the reference's, on the CPU.

Every dense arch in the port's registry, cut by ``reduced_config`` (d_model
64, 2 periods, 4 heads, vocab <= 512, window 16), with the reference's
weights (``init_params(cfg, PRNGKey(0))``) handed over as numpy:

* forward logits (tokens, and pixtral's embeddings), the prefill's
  last-position logits and exact-length caches, ``init_cache``'s shapes and
  ``len``: within rtol 1e-5, atol 1e-5 (fp32 rounding of the same ops over
  two layers; logits are O(1));
* the prefill's one-position projection (``forward(..., last=1)``) against
  the last row of the full projection: within the same tolerance;
* 8 greedy decode steps, each step's logits against the reference's jitted
  serve step fed the same tokens (past the window of 16): within rtol 1e-5,
  atol 1e-5;
* decode against the port's own full forward over prompt and tokens (the
  cache's coherence): within rtol 1e-5, atol 1e-5;
* 1 and 8 AdamW / Adafactor / momentum train steps, one of them with 2
  microbatches: the loss within rtol 1e-5; every param within rtol 1e-4,
  atol 1e-6, except at most 0.1% of the elements, which stay within
  0.1 x the learning rate (3e-5): Adam divides each gradient by its own
  RMS, so an element whose gradient is at the level of fp32 rounding noise
  steps by a fraction of the learning rate either way;
* every config of the reference's registry (the dense ones here, the MoE,
  MLA, recurrent and encoder ones in ``tests/test_torch_zoo_*.py``) equals
  the port's field for field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_REGISTRY as JAX_ARCHS
from repro.configs.base import reduced_config as jax_reduced
from repro.models.model import forward as jax_forward
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params
from repro.models.steps import TrainState as JaxTrainState
from repro.models.steps import make_optimizer as jax_make_optimizer
from repro.models.steps import make_prefill_step as jax_prefill_step
from repro.models.steps import make_serve_step as jax_serve_step
from repro.models.steps import make_train_step as jax_train_step
from repro_torch.common.pytrees import tree_leaves, tree_map
from repro_torch.configs import ARCH_REGISTRY, base as port_base, get_config, reduced_config
from repro_torch.interop import tree_from_numpy
from repro_torch.launch.serve import decode, prefill
from repro_torch.models.model import forward, graft, init_cache
from repro_torch.models.steps import TrainState, make_optimizer, make_prefill_step, make_serve_step, make_train_step
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

RTOL, ATOL = 1e-5, 1e-5
DENSE = sorted(["tiny_lm", "llama3.2-1b", "gemma2-2b", "command-r-35b", "llama3-405b", "pixtral-12b"])
B, S, GEN = 2, 12, 8


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reduced configs and the reference's weights (jax and torch); shared, never written."""
    jcfg = jax_reduced(JAX_ARCHS[name])
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, reduced_config(get_config(name)), jp, tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    return (request.param, *_weights(request.param))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _jax_graft(fixed, pre):
    if fixed.shape == pre.shape:
        return pre
    axis = next(i for i, (a, b) in enumerate(zip(fixed.shape, pre.shape)) if a != b)
    pad = [(0, 0)] * fixed.ndim
    pad[axis] = (0, fixed.shape[axis] - pre.shape[axis])
    return jnp.pad(pre, pad)


def test_every_dense_arch_is_registered():
    """All 11 of the reference's configs are registered, each equal to the
    reference's field for field (the dense ones are this file's)."""
    assert set(DENSE) < set(ARCH_REGISTRY) == set(JAX_ARCHS) and len(ARCH_REGISTRY) == 11
    for name in JAX_ARCHS:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(JAX_ARCHS[name]), name
        assert get_config(name) == _port_config(JAX_ARCHS[name]), name


def test_forward_logits(arch):
    _, jcfg, tcfg, jp, tp = arch
    tok = _tokens(tcfg, (B, S))
    want = np.asarray(jax_forward(jcfg, jp, {"tokens": jnp.asarray(tok)})[0])
    got, aux, cache = forward(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    last = forward(tcfg, tp, {"tokens": torch.from_numpy(tok)}, last=1)[0]
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=RTOL, atol=ATOL)
    if tcfg.embeds_input:
        emb = np.random.default_rng(2).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
        want = np.asarray(jax_forward(jcfg, jp, {"embeds": jnp.asarray(emb)})[0])
        got = forward(tcfg, tp, {"embeds": torch.from_numpy(emb)})[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_prefill_logits_caches_and_init_cache(arch):
    _, jcfg, tcfg, jp, tp = arch
    tok = _tokens(tcfg, (B, S))
    jl, jc = jax.jit(jax_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(tok)})
    tl, tc = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    assert tc["len"] == int(jc["len"]) == S
    jleaves = jax.tree_util.tree_leaves(jc["blocks"])
    tleaves = tree_leaves(tc["blocks"])
    assert len(jleaves) == len(tleaves) == 2 * len(tcfg.pattern)
    for a, b in zip(tleaves, jleaves):
        assert tuple(a.shape) == b.shape == (tcfg.num_periods, B, S, tcfg.num_kv_heads, tcfg.resolved_head_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    fixed = init_cache(tcfg, B, ctx_len=S, margin=GEN + 8)
    jfixed = jax_init_cache(jcfg, B, ctx_len=S, margin=GEN + 8)
    assert fixed["len"] == int(jfixed["len"]) == S
    assert [tuple(t.shape) for t in tree_leaves(fixed["blocks"])] == [
        t.shape for t in jax.tree_util.tree_leaves(jfixed["blocks"])]
    grafted = tree_map(graft, fixed, tc)
    for a, b in zip(tree_leaves(grafted["blocks"]), tleaves):
        assert torch.equal(a[:, :, :S], b) and not a[:, :, S:].any()


def test_decode_steps_match_the_references_serve_step(arch):
    _, jcfg, tcfg, jp, tp = arch
    tok = _tokens(tcfg, (B, S))
    jl, jpre = jax.jit(jax_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(tok)})
    jcache = jax.tree_util.tree_map(_jax_graft, jax_init_cache(jcfg, B, ctx_len=S, margin=GEN + 8), jpre)
    serve = jax.jit(jax_serve_step(jcfg))
    tl, tcache = prefill(tcfg, tp, torch.from_numpy(tok), GEN)
    feed = _tokens(tcfg, (B, GEN), seed=5)  # the same tokens into both, past the window of 16
    tserve = make_serve_step(tcfg)
    for i in range(GEN):
        jl, jcache = serve(jp, jcache, {"tokens": jnp.asarray(feed[:, i:i + 1])})
        tl, tcache = tserve(tp, tcache, {"tokens": torch.from_numpy(feed[:, i:i + 1])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL, err_msg=f"step {i}")
    assert tcache["len"] == int(jcache["len"]) == S + GEN


def test_decode_matches_the_ports_full_forward(arch):
    _, _, tcfg, _, tp = arch
    prompts = torch.from_numpy(_tokens(tcfg, (B, S)))
    logits, cache = prefill(tcfg, tp, prompts, GEN)
    toks, steps = decode(tcfg, tp, cache, logits, GEN, keep_logits=True)
    full = forward(tcfg, tp, {"tokens": torch.cat([prompts, toks], dim=1)})[0]
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S - 1].numpy(), rtol=RTOL, atol=ATOL)
    for i, step in enumerate(steps):
        np.testing.assert_allclose(step.numpy(), full[:, S + i].numpy(), rtol=RTOL, atol=ATOL, err_msg=f"step {i}")
    assert torch.equal(toks[:, 1:], torch.argmax(full[:, S:S + GEN - 1, : tcfg.vocab_size], dim=-1))


TRAIN_CASES = {  # arch, train spec change
    "gemma2-2b": {},  # adamw
    "llama3-405b": {},  # adafactor
    "tiny_lm": {},  # momentum
    "command-r-35b": {"microbatches": 2},
}


@functools.lru_cache(maxsize=None)
def _train_runs(name):
    """Both packages' train states and every step's metrics after 1 and
    after 8 steps on the same batches."""
    jcfg, tcfg, jp, tp = _weights(name)
    change = TRAIN_CASES[name]
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **change))
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, **change))
    jstep, tstep = jax.jit(jax_train_step(jcfg)), make_train_step(tcfg)
    jopt, topt = jax_make_optimizer(jcfg), make_optimizer(tcfg)
    js = JaxTrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    ts = TrainState(tp, topt.init(tp), torch.zeros((), dtype=torch.int32))
    out, metrics = {}, []
    for i in range(8):
        tok = _tokens(tcfg, (4, S + 1), seed=10 + i)
        labels = tok[:, 1:].copy()
        labels[0, :3] = tcfg.vocab_size  # masked pad labels
        batch = {"tokens": tok[:, :-1], "labels": labels}
        js, jm = jstep(js, jax.tree_util.tree_map(jnp.asarray, batch))
        ts, tm = tstep(ts, batch)
        metrics.append((jm, tm))
        if i + 1 in (1, 8):
            out[i + 1] = (tcfg, js, ts, list(metrics))
    return out


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_steps_match_the_reference(name, steps):
    tcfg, js, ts, metrics = _train_runs(name)[steps]
    for i, (jm, tm) in enumerate(metrics):
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, err_msg=f"{k}, step {i}")
    assert int(tm["step"]) == int(jm["step"]) == steps
    lr = tcfg.train.learning_rate
    off = total = 0
    for a, b in zip(tree_leaves(ts.params), jax.tree_util.tree_leaves(js.params)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0.1 * lr)
        off += int((np.abs(a - b) > 1e-6 + 1e-4 * np.abs(b)).sum())
        total += a.size
    assert off <= 1e-3 * total, f"{off} of {total} params beyond atol 1e-6"
    assert not any(t.requires_grad for t in tree_leaves(ts.params))


def _port_config(jcfg):
    """The reference's config as the port's dataclasses (field for field)."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(port_base, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)})
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return conv(jcfg)


@pytest.mark.parametrize("opts", [dict(causal=True), dict(causal=True, window=5, softcap=50.0, q_pos0=7),
                                  dict(causal=False, chunk_q=3), dict(causal=True, window=4, q_pos0=3, chunk_q=4)],
                         ids=str)
def test_attention_scores_reference_matches_the_references(opts):
    """The decode step's plain attention (grouped queries, ``chunk_q``
    blocks, a ragged tail) against the reference's (repeated KV heads)."""
    from repro.models.layers import attention_scores_reference as jax_scores
    from repro_torch.models.layers import attention_scores_reference

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 10, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 14, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 14, 2, 8)).astype(np.float32)
    want = jax_scores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3, **opts)
    got = attention_scores_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=0.3, **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_apply_attention_with_a_cache_matches_the_references():
    """``apply_attention`` with a prepended cache, ``pos0``, a local window
    and ``return_cache``, gemma's layer 0, against the reference's."""
    from repro.models.layers import apply_attention as jax_apply_attention
    from repro_torch.models.layers import apply_attention

    jcfg, tcfg, jp, tp = _weights("gemma2-2b")
    jmix = jax.tree_util.tree_map(lambda t: t[0], jp["blocks"]["slot0"]["mixer"])
    tmix = tree_map(lambda t: t[0], tp["blocks"]["slot0"]["mixer"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, 20, tcfg.num_kv_heads, tcfg.resolved_head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    want, wnew = jax_apply_attention(jmix, jnp.asarray(x), jcfg, local=True, pos0=20, return_cache=True,
                                     cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)})
    got, gnew = apply_attention(tmix, torch.from_numpy(x), tcfg, local=True, pos0=20, return_cache=True,
                                cache={"k": torch.from_numpy(ck), "v": torch.from_numpy(cv)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(gnew[name].numpy(), np.asarray(wnew[name]), rtol=RTOL, atol=ATOL)
