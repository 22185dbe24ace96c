"""The port's standalone example mains (``movielens-eval``,
``lambda-sweep``, ``sharded-scale``) run as a user runs them, on the
host: ``python engine_torch.py --device cpu`` in a copy of the example's
directory, as a process with its own time limit, exiting 0 without JAX
or the JAX package ever loaded.  sharded-scale runs on a mesh of 8 host
shards (the reference's test gives its example 8 virtual devices) and
prints what ``tests/test_examples.py`` reads of the reference's; its
replicated factors, started from the JAX trainer's initial factors,
match the reference's single-device replicated train within 1e-4 of
their scale, the training RMSE within 1e-5 relative.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_examples_common import (
    EXAMPLES,
    example,
    one_torch_thread,
    same_als,
    start_from_jax,
)

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

ROOT = EXAMPLES.parent

# runs a main as ``python engine_torch.py ARGS`` would, then names the
# forbidden packages that were loaded
_PROBE = (
    "import json, runpy, sys\n"
    "sys.argv = ['engine_torch.py', *sys.argv[1:]]\n"
    "sys.path.insert(0, '.')\n"
    "runpy.run_path('engine_torch.py', run_name='__main__')\n"
    "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}\n"
    "                        & {'jax', 'jaxlib', 'predictionio_tpu'})))\n"
)

MAINS = {
    "movielens-eval": ["--device", "cpu"],
    "lambda-sweep": ["--device", "cpu"],
    "sharded-scale": ["--device", "cpu", "--shards", "8"],
}


def _run_main(tmp_path, name: str) -> str:
    work = tmp_path / name
    shutil.copytree(EXAMPLES / name, work)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(ROOT), PIO_TPU_HOME=str(work / ".home"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *MAINS[name]], cwd=work, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"{name} main failed:\n{proc.stderr[-3000:]}"
    *out, loaded = proc.stdout.splitlines()
    assert json.loads(loaded) == [], f"{name} loaded {loaded}"
    return "\n".join(out)


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_without_jax(tmp_path, name):
    out = _run_main(tmp_path, name)
    if name == "movielens-eval":
        # the one-line result (the winner's MSE), and best.json in the
        # working directory
        assert re.fullmatch(r"\[\d+\.\d+\] MSE", out.splitlines()[-1]), out
        assert (tmp_path / name / "best.json").is_file()
    elif name == "lambda-sweep":
        assert "best lambda" in out
        best = float(out.rsplit("best lambda = ", 1)[1].split()[0])
        assert best in (0.05, 0.1)
    else:
        assert "mesh: 8 shard(s) of cpu" in out
        assert "resolved solver: 'fused'" in out
        assert "sharded-scale OK" in out and "each device stores" in out
        stored = int(re.search(r"each device stores ([\d,]+)", out)
                     .group(1).replace(",", ""))
        assert stored < 40_000 / 4


def test_sharded_scale_matches_the_reference(monkeypatch, capsys):
    """``run(8, "cpu")`` from the JAX trainer's initial factors: both
    placements' factors against the reference's single-device train."""
    from predictionio_tpu.models.als import (
        ALSConfig as JaxALSConfig,
        ALSTrainer as JaxALSTrainer,
    )

    start_from_jax(monkeypatch)
    with example("sharded-scale") as (ref, port):
        f_rep, f_sh = port.run(8, "cpu")
        u, i, v, nu, ni = ref.synth()
    out = capsys.readouterr().out
    assert "sharded-scale OK" in out and "(compile-probed)" not in out
    want = JaxALSTrainer((u, i, v), nu, ni,
                         JaxALSConfig(rank=8, num_iterations=4)).train()
    want = (np.asarray(want.user_factors), np.asarray(want.item_factors))
    same_als((f_rep.user_factors, f_rep.item_factors), want, (u, i, v))
    same_als((f_sh.user_factors, f_sh.item_factors), want, (u, i, v))


def test_the_mains_take_the_card_by_default(monkeypatch):
    """With no ``--device`` each main asks for the card: where there is
    none it raises rather than carrying on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in MAINS:
        with example(name) as (_, port):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port.main([])
