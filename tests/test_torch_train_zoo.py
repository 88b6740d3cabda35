"""Training the model zoo's reduced MoE and Mamba archs on the CPU, the
port against the reference (``tests/torch_train.py`` says how):
deepseek-v2-lite-16b (MLA, a dense prefix layer, MoE) through the
driver after 1 and 8 steps; remat on and off giving the same bits for
deepseek-v2-lite-16b and jamba (Mamba, MoE), and eval and prefill
unchanged under it.
"""
import pytest

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)
from torch_train import check_driver, check_eval_and_prefill, check_remat

REMAT_ARCHS = ("deepseek-v2-lite-16b", "jamba-1.5-large-398b")


@pytest.mark.parametrize("steps", [1, 8])
def test_driver_matches_the_references_loop(steps):
    check_driver("deepseek-v2-lite-16b", steps)


@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_remat_changes_no_bit(name, monkeypatch):
    check_remat(name, monkeypatch)


@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_eval_and_prefill_run_each_layer_once_under_remat(name, monkeypatch):
    check_eval_and_prefill(name, monkeypatch)
