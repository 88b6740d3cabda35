"""The port's serving path against the reference's, on the CPU.

The per-cluster serving example (``repro_torch.launch.serve_cluster_models``)
runs with the reference's initial weights and broadcast RNN handed over;
the reference runs the same steps as ``examples/serve_cluster_models.py``
(its functions, jitted). Identical: the clusters, the assignment, the
server's events and ``stats()`` (bar the floats of the feedback means,
none here), the prompts. The centers within rtol 1e-4, atol 1e-5 (120
AdamW steps in each package). Served logits within atol 1e-4; tokens equal
at every position where the reference's top-2 logit margin exceeds that
tolerance, up to the first position of a row where it does not and the
tokens differ (the rest of that row is exempt; the count is printed). The
pytree backend serves the same as the plane backend. The serving CLI runs with
``--reduced --device cpu``; ``--mesh pod`` and an encoder raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCH_REGISTRY
from repro.configs.base import reduced_config
from repro.core.broadcast import pretrain_rnn as jax_pretrain_rnn
from repro.core.server import EchoPFLServer
from repro.data.lm import token_stream
from repro.models import init_cache, init_params, make_serve_step, make_train_step
from repro.models.steps import TrainState, make_optimizer, make_prefill_step
from repro_torch.configs import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.launch.sharded import ShardedTree
from repro_torch.launch.serve_cluster_models import main as port_example
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

TOL = 1e-4


def reference_example():
    """``examples/serve_cluster_models.py``'s steps, returning what it serves."""
    cfg = reduced_config(ARCH_REGISTRY["gemma2-2b"], d_model=64, periods=2)
    init = init_params(cfg, jax.random.PRNGKey(0))
    opt = make_optimizer(cfg)
    train = jax.jit(make_train_step(cfg))
    server = EchoPFLServer(init, num_initial_clusters=2, seed=0)
    streams = [token_stream(cfg.vocab_size, seed=i % 2) for i in range(4)]
    states = [TrainState(init, opt.init(init), jnp.zeros((), jnp.int32)) for _ in range(4)]
    for rnd in range(40):
        cid = rnd % 4
        st = states[cid]._replace(params=server.model_for(cid))
        for _ in range(3):
            st, _ = train(st, next(streams[cid]))
        states[cid] = st
        server.handle_upload(cid, st.params, 0, 128, t=float(rnd))
    prefill = jax.jit(make_prefill_step(cfg))
    serve = jax.jit(make_serve_step(cfg), donate_argnums=1)
    by_cluster: dict = {}
    for c in range(4):
        by_cluster.setdefault(server.clustering.assignment[c], []).append(c)
    rng = np.random.default_rng(0)
    served = {}
    for cluster_id, clients in sorted(by_cluster.items()):
        params = server.clustering.clusters[cluster_id].center
        B, L, gen = len(clients), 8, 16
        prompts = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, L)))
        logits, pre_cache = prefill(params, {"tokens": prompts})
        cache = init_cache(cfg, B, ctx_len=L, margin=gen + 8)

        def graft(fixed, pre):
            if fixed.shape == pre.shape:
                return pre
            axis = next(i for i, (a, b) in enumerate(zip(fixed.shape, pre.shape)) if a != b)
            pad = [(0, 0)] * fixed.ndim
            pad[axis] = (0, fixed.shape[axis] - pre.shape[axis])
            return jnp.pad(pre, pad)

        cache = jax.tree_util.tree_map(graft, cache, pre_cache)
        toks, lgs = [], []
        tok = jnp.argmax(logits[:, -1, : cfg.vocab_size], axis=-1)[:, None]
        for _ in range(gen):
            toks.append(np.asarray(tok))
            lgs.append(np.asarray(logits[:, -1]))
            logits, cache = serve(params, cache, {"tokens": tok})
            tok = jnp.argmax(logits[:, -1, : cfg.vocab_size], axis=-1)[:, None]
        served[cluster_id] = {"clients": clients, "prompts": np.asarray(prompts),
                              "tokens": np.concatenate(toks, axis=1), "logits": np.stack(lgs)}
    return init, server, served


@pytest.fixture(scope="module")
def runs():
    init, jserver, jserved = reference_example()
    init_np = jax.tree_util.tree_map(np.asarray, init)
    rnn_np = {k: np.asarray(v) for k, v in jax_pretrain_rnn(jax.random.PRNGKey(0)).items()}
    plane = port_example("cpu", init_params=init_np, rnn_params=rnn_np, verbose=False)
    tree = port_example("cpu", init_params=init_np, rnn_params=rnn_np, plane_backend="pytree", verbose=False)
    return (jserver, jserved), plane, tree


def margin_rule(tokens, ref_tokens, ref_logits, vocab, tol):
    """Positions checked and exempt: each row is checked while the
    reference's top-2 margin exceeds ``tol``; at the first position where
    it does not and the tokens differ, the rest of the row is exempt."""
    checked = exempt = 0
    top2 = np.sort(ref_logits[..., :vocab], axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).T  # (B, gen)
    for b in range(tokens.shape[0]):
        for t in range(tokens.shape[1]):
            if margin[b, t] > tol:
                assert tokens[b, t] == ref_tokens[b, t], f"row {b}, position {t}: margin {margin[b, t]}"
                checked += 1
            elif tokens[b, t] != ref_tokens[b, t]:
                exempt += tokens.shape[1] - t
                break
            else:
                exempt += 1
    return checked, exempt


def test_clusters_assignment_and_events_equal_the_references(runs):
    (jserver, _), plane, _ = runs
    tserver = plane["server"]
    assert tserver.clustering.assignment == jserver.clustering.assignment
    assert sorted(tserver.clustering.clusters) == sorted(jserver.clustering.clusters)
    assert tserver.events == jserver.events
    assert {e["kind"] for e in tserver.events} == {"broadcast"}
    assert tserver.stats() == jserver.stats()
    for cid, c in jserver.clustering.clusters.items():
        np.testing.assert_allclose(tserver.clustering.clusters[cid].center_vec.numpy(), np.asarray(c.center_vec),
                                   rtol=1e-4, atol=1e-5)


def test_served_tokens_follow_the_references_under_the_margin_rule(runs):
    (_, jserved), plane, _ = runs
    vocab = 512  # the reduced vocab
    assert sorted(plane["served"]) == sorted(jserved)
    total_exempt = 0
    for cid, want in jserved.items():
        got = plane["served"][cid]
        assert got["clients"] == want["clients"]
        assert np.array_equal(got["prompts"], want["prompts"])
        checked, exempt = margin_rule(got["tokens"], want["tokens"], want["logits"], vocab, TOL)
        assert checked + exempt == got["tokens"].size
        total_exempt += exempt
        rows_same = (got["tokens"] == want["tokens"]).all(axis=1)
        np.testing.assert_allclose(got["logits"][:, rows_same], want["logits"][:, rows_same], rtol=0, atol=TOL)
    print(f"served tokens: {total_exempt} positions exempt under the margin rule")


def test_pytree_backend_serves_what_the_plane_backend_serves(runs):
    _, plane, tree = runs
    assert tree["server"].stats()["backend"] == "pytree" and tree["server"].stats()["plane_rows"] == 0
    assert tree["server"].clustering.assignment == plane["server"].clustering.assignment
    assert tree["server"].events == plane["server"].events
    for cid, got in tree["served"].items():
        assert np.array_equal(got["tokens"], plane["served"][cid]["tokens"])
        np.testing.assert_allclose(got["logits"], plane["served"][cid]["logits"], rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", ["gemma2-2b", "pixtral-12b"])
def test_serve_cli_runs_reduced_on_the_cpu(arch, capsys):
    out = port_serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt", "20", "--gen", "6",
                           "--device", "cpu"])
    assert out["tokens"].shape == (2, 6) and tuple(out["prompts"].shape) == (2, 20)
    assert 0 <= out["tokens"].min() and out["tokens"].max() < 512
    assert out["launches"]["prefill"]["flash_attention_fwd"] == 0  # CPU tensors take the plain version
    text = capsys.readouterr().out
    assert "prefill: 2x20" in text and "tok/s" in text and "sample:" in text


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_serve_cli_meshes_beyond_one_card_raise(mesh):
    """``--mesh pod`` and ``multipod`` serve a dense decoder over the CPU
    repeated, the batch split over every data shard: the parameters are
    placed in blocks and the tokens are the one-device run's. So do the
    archs with MoE, MLA, Mamba, mLSTM and sLSTM layers (none raises now):
    the MoE archs with the batch split over every data shard, the recurrent
    archs at batch 2 (one shard, every layer over the 16 model ranks)."""
    batch = 16 if mesh == "pod" else 32
    args = ["--arch", "gemma2-2b", "--reduced", "--batch", str(batch), "--prompt", "8", "--gen", "2", "--device", "cpu"]
    out = port_serve.main(args + ["--mesh", mesh])
    assert isinstance(out["params"], ShardedTree) and out["params"].layout.mesh.size == batch * 16
    assert out["tokens"].shape == (batch, 2)
    np.testing.assert_array_equal(out["tokens"], port_serve.main(args)["tokens"])
    for arch in ("deepseek-v2-lite-16b", "granite-moe-3b-a800m", "jamba-1.5-large-398b", "xlstm-1.3b"):
        rows = batch if "moe" in arch or "deepseek" in arch else 2
        args = ["--arch", arch, "--reduced", "--batch", str(rows), "--prompt", "8", "--gen", "2", "--device", "cpu"]
        out = port_serve.main(args + ["--mesh", mesh])
        assert isinstance(out["params"], ShardedTree) and out["tokens"].shape == (rows, 2)
        np.testing.assert_array_equal(out["tokens"], port_serve.main(args)["tokens"])


def test_serve_refuses_an_encoder():
    cfg = dataclasses.replace(get_config("tiny_lm"), is_encoder=True, causal=False)
    with pytest.raises(SystemExit, match="encoder-only"):
        port_serve.serve(cfg, batch=1, prompt=4, gen=2, device="cpu")
