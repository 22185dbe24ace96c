"""The port's ALS configuration and device defaults: the same validation
as the JAX package's ``ALSConfig``, a clear error for options whose code
is not ported yet, and entry points that default to the card."""

import dataclasses

import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import ALSConfig as JaxALSConfig
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSFactors,
    ALSTrainer,
    rmse,
)


@pytest.mark.parametrize("kw,match", [
    (dict(factor_placement="sharded"), "not yet ported"),
    (dict(factor_placement="sharded", coded_shards=True), "not yet ported"),
    # ported: these build the reference's config, field for field
    (dict(solver_mode="subspace", solver="pallas"), None),
    (dict(gather_mode="grouped"), None),
    (dict(retrieval="ivf", nprobe=4), None),
])
def test_unported_options_raise(kw, match):
    if match is None:
        got = dataclasses.asdict(ALSConfig(**kw))
        want = dataclasses.asdict(JaxALSConfig(**kw))
        assert got == want
        return
    with pytest.raises(NotImplementedError, match=match):
        ALSConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(solver="cusolver"), dict(gather_dtype="f16"),
    dict(fused_gather="taa"), dict(solver="fused", fused_gather="take"),
    dict(loss_every=-1),
    dict(coded_shards=True),
])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        JaxALSConfig(**kw)
    with pytest.raises(ValueError):
        ALSConfig(**kw)


def test_port_validates_precision_up_front():
    with pytest.raises(ValueError, match="matmul_precision"):
        ALSConfig(matmul_precision="tf32")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    u = np.array([0, 1], np.int32)
    v = np.array([1.0, 2.0], np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALSTrainer((u, u, v), 2, 2, ALSConfig(rank=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rmse(ALSFactors(np.zeros((2, 3)), np.zeros((2, 3))),
             np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1))
