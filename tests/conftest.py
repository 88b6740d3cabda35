"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the 1 real CPU device (the 512-device override
belongs exclusively to launch/dryrun.py, per the brief)."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def tiny_params():
    """Session-scoped tiny MLP-shaped pytree (ragged leaf shapes, 187 params).

    Shared by the plane/kernel/server tests so the flatten spec and its jit
    caches are built once per session instead of once per test."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    return {
        "dense1": {
            "w": jax.random.normal(k1, (16, 8), jnp.float32),
            "b": jnp.zeros((8,), jnp.float32),
        },
        "dense2": {
            "w": jax.random.normal(k2, (8, 4), jnp.float32),
            "b": jnp.zeros((4,), jnp.float32),
        },
        "head": {"w": jax.random.normal(k3, (4, 3), jnp.float32), "scale": jnp.ones(())},
    }


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips with a reason elsewhere")
