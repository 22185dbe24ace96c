"""The port's step checkpointer, checkpointed train and λ sweep, on the
CPU.

``StepCheckpointer`` keeps the reference's API (save, latest_step,
restore with ``like``, keep, last_restored_step) and its torn-newest
fallback; a checkpointed ``train`` resumed from a step equals an
uninterrupted run bit for bit; ``sweep_train_als`` gives each λ the JAX
package's sweep model within 1e-4 of the factors' scale, from the same
initial factors (the JAX trainer's ``init_factors``).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
    sweep_train_als as jax_sweep_train_als,
)
from predictionio_tpu_torch.convert import factors_from_jax
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSTrainer,
    sweep_train_als,
)
from predictionio_tpu_torch.workflow.checkpoint import StepCheckpointer


def _toy(n_users=30, n_items=20, density=0.5, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 3))
    V = rng.normal(size=(n_items, 3))
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    v = (U @ V.T)[u, i].astype(np.float32)
    return u.astype(np.int32), i.astype(np.int32), v, n_users, n_items


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_save_restore_and_keep(tmp_path):
    ck = StepCheckpointer(tmp_path / "ck", keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for step in (1, 2, 3):
        ck.save(step, {"U": torch.full((3, 2), float(step)),
                       "V": np.arange(4, dtype=np.float32) * step})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    got = ck.restore()
    assert ck.last_restored_step == 3
    assert torch.equal(got["U"], torch.full((3, 2), 3.0))
    assert torch.equal(got["V"], torch.arange(4, dtype=torch.float32) * 3)
    like = {"U": torch.zeros((3, 2), dtype=torch.float64)}
    old = ck.restore(2, like=like)
    assert ck.last_restored_step == 2
    assert old["U"].dtype == torch.float64 and float(old["U"][0, 0]) == 2.0
    # no stray temporary files
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000002.pt", "step_00000003.pt"]


def test_a_torn_newest_step_falls_back_but_an_explicit_one_does_not(
        tmp_path):
    ck = StepCheckpointer(tmp_path / "ck", keep=3)
    for step in (4, 8):
        ck.save(step, {"U": torch.full((2, 2), float(step))})
    newest = tmp_path / "ck" / "step_00000008.pt"
    newest.write_bytes(newest.read_bytes()[:40])
    got = ck.restore()
    assert ck.last_restored_step == 4
    assert float(got["U"][0, 0]) == 4.0
    with pytest.raises(Exception):
        ck.restore(8)
    assert ck.last_restored_step == 4


def test_resume_equals_an_uninterrupted_run(tmp_path):
    u, i, v, nu, ni = _toy(seed=1)
    cfg = ALSConfig(rank=4, num_iterations=4, lam=0.05, solver="pallas")
    whole = ALSTrainer((u, i, v), nu, ni, cfg, device="cpu").train()
    ck = StepCheckpointer(tmp_path / "ck")
    first = ALSTrainer((u, i, v), nu, ni,
                       ALSConfig(rank=4, num_iterations=2, lam=0.05,
                                 solver="pallas"), device="cpu")
    first.train(checkpointer=ck, checkpoint_every=1)
    assert ck.all_steps() == [1, 2]
    # a new trainer resumes from the latest step and saves every other
    again = ALSTrainer((u, i, v), nu, ni, cfg, device="cpu")
    got = again.train(checkpointer=ck, checkpoint_every=2)
    assert ck.last_restored_step == 2
    assert ck.all_steps() == [1, 2, 4]
    assert len(got.report["half_seconds"]) == 2 * 2
    assert np.array_equal(got.user_factors, whole.user_factors)
    assert np.array_equal(got.item_factors, whole.item_factors)
    with pytest.raises(ValueError, match="checkpoint_every"):
        again.train(checkpointer=ck, checkpoint_every=0)
    # resume=False starts over and writes the steps anew
    fresh = again.train(checkpointer=ck, checkpoint_every=4, resume=False)
    assert np.array_equal(fresh.user_factors, whole.user_factors)


@pytest.mark.parametrize("implicit", [False, True])
def test_sweep_matches_the_references_per_lambda(implicit):
    u, i, v, nu, ni = _toy(seed=2)
    if implicit:
        v = np.abs(v) + 0.5
    kw = dict(rank=4, num_iterations=2, implicit=implicit, alpha=1.5,
              weighted_lambda=not implicit)
    lams = (0.01, 0.05, 0.1)
    want = jax_sweep_train_als((u, i, v), nu, ni, JaxALSConfig(**kw), lams)
    U0, V0 = JaxALSTrainer((u, i, v), nu, ni,
                           JaxALSConfig(**kw)).init_factors()
    got = sweep_train_als((u, i, v), nu, ni, ALSConfig(**kw), lams,
                          device="cpu",
                          init=factors_from_jax(U0, V0, "cpu"))
    assert len(got) == len(want) == 3
    for g, w, lam in zip(got, want, lams):
        _rel_close(g.user_factors, w.user_factors, 1e-4)
        _rel_close(g.item_factors, w.item_factors, 1e-4)
        # and each is the port's own sequential train at that λ
        one = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw, lam=lam),
                         device="cpu").train(
            init=factors_from_jax(U0, V0, "cpu"))
        _rel_close(g.user_factors, one.user_factors, 1e-5)
    assert sweep_train_als((u, i, v), nu, ni, ALSConfig(**kw), (),
                           device="cpu") == []


def test_sweep_refuses_the_kernels_as_the_reference_does():
    u, i, v, nu, ni = _toy(seed=3)
    for solver in ("pallas", "fused"):
        cfg = dict(rank=4, num_iterations=1, solver=solver)
        with pytest.raises(ValueError, match="requires solver='xla'"):
            jax_sweep_train_als((u, i, v), nu, ni, JaxALSConfig(**cfg),
                                (0.1,))
        with pytest.raises(ValueError, match="requires solver='xla'"):
            sweep_train_als((u, i, v), nu, ni, ALSConfig(**cfg), (0.1,),
                            device="cpu")
