"""piolint over the port — torch-aware static analysis, lock-discipline,
deadlock, and contract-drift checking.

The port's counterpart of the reference's ``predictionio_tpu/analysis``:
AST engines over the port's own source (no imports, no torch, no
device), with the reference's rule ids, finding shapes, inline
suppressions and baseline matching.  Per-file: the **torch engine**
(PIO101–104, PIO106, PIO108, `torchlint.py`, jaxlint's counterpart)
walks functions reachable from ``torch.compile``/``torch.jit``/
``torch.func`` tracing and CUDA graph captures and flags host-device
syncs, data-dependent control flow, string formatting of traced values,
and unfenced timing spans in ``chip_smoke.py`` and
``kernel_variants.py``; the **clock engine** (PIO109, `timelint.py`)
flags wall-clock ``time.time()`` t0/dt subtractions in
``predictionio_tpu_torch/``; the **event-loop engine** (PIO110,
`asynclint.py`) flags blocking calls inside coroutines and loop-thread
callbacks; the **lock engine** (PIO201–203, `locklint.py`) infers
per-class lock discipline and flags off-lock accesses; the
**engine-isolation engine** (PIO301, `enginelint.py`) keeps templates
off server internals.

Whole-program (run once over the full analyzed set): the **deadlock
engine** (PIO210–213, `deadlint.py`) builds a cross-class lock-order
graph and flags lock-order inversions, callbacks invoked under a lock,
blocking calls in lock-held regions, and condition-variable misuse;
the **contract engine** (PIO401–403, `contractlint.py`) checks that
``pio_*`` metric families / labels and fault-point strings referenced
by ``chip_smoke.py``, the dashboard and the port's tests exist in the
port's obs catalog and fault registry.

Driver: ``python -m predictionio_tpu_torch.analysis`` (see `cli.py`;
also ``--format json|sarif``).  Findings are suppressed inline with
``# piolint: disable=PIO101`` or accepted in ``analysis/baseline.json``
(matched by path/rule/scope/snippet, so line drift doesn't churn the
baseline; every entry carries a written ``justification``, which
``--strict`` enforces for deadlock entries).  The process exits 1 on
any finding neither suppressed nor baselined.
"""

from .cli import analyze_file, analyze_paths, main
from .core import (
    RULES,
    Baseline,
    Finding,
    SourceFile,
    load_baseline,
)

__all__ = [
    "RULES",
    "Baseline",
    "Finding",
    "SourceFile",
    "load_baseline",
    "analyze_file",
    "analyze_paths",
    "main",
]
