"""The port's debug switches (``utils/debug.py``): ``deterministic_mode``
sets every flag it names, yields a generator seeded as asked and restores
every setting on exit, an exception included; ``enable_nan_checks`` raises
on a module's NaN or infinite output, naming the module, and turns on
autograd's anomaly mode; ``disable_nan_checks`` undoes both."""

import os

import pytest
import torch
from torch import nn

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils import debug


def _flags():
    return (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(), os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


@pytest.fixture
def odd_flags(monkeypatch):
    """Settings unlike the mode's, restored after the test whatever it does."""
    before = _flags()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    yield _flags()
    algos, warn_only, tf32, cudnn_tf32, precision, _ = before
    torch.use_deterministic_algorithms(algos, warn_only=warn_only)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(precision)


@pytest.mark.parametrize("raises", [False, True])
def test_deterministic_mode_sets_and_restores_every_flag(odd_flags, raises):
    with pytest.raises(KeyError) if raises else torch.no_grad():
        with debug.deterministic_mode(7) as gen:
            assert _flags() == (True, False, False, False, "highest", ":4096:8")
            assert torch.equal(torch.randn(5, generator=gen),
                               torch.randn(5, generator=torch.Generator().manual_seed(7)))
            if raises:
                raise KeyError("inside the region")
    assert _flags() == odd_flags


def test_deterministic_mode_removes_a_workspace_it_set(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = _flags()
    with debug.deterministic_mode(0):
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    assert _flags() == before


class _Poison(nn.Module):
    def __init__(self, value: str = "nan"):
        super().__init__()
        self.value = float(value)

    def forward(self, x):
        return x * self.value


@pytest.fixture
def nan_checks():
    debug.enable_nan_checks()
    try:
        yield
    finally:
        debug.disable_nan_checks()


@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_nan_checks_name_the_module(nan_checks, bad):
    assert torch.is_anomaly_enabled()
    model = nn.Sequential(nn.Linear(4, 4), _Poison(bad))
    x = torch.ones(2, 4)
    model[0](x)  # a finite output passes
    with pytest.raises(FloatingPointError, match="_Poison produced a non-finite output"):
        model(x)


def test_nan_checks_pass_integer_and_finite_outputs(nan_checks):
    emb = nn.Embedding(10, 3)
    assert torch.isfinite(emb(torch.arange(4))).all()
    assert nn.Identity()(torch.arange(4)).dtype == torch.int64


def test_disable_nan_checks_undoes_both():
    debug.enable_nan_checks()
    debug.disable_nan_checks()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(_Poison()(torch.ones(2))).all()
