"""Multi-process sharded event ingest (port of
``predictionio_tpu/parallel/ingest.py``: host code, numpy and files,
with the ``torch.distributed`` process group of
``parallel.mesh.distributed_init`` in place of the reference's
``multihost_utils``).

PredictionIO read training data region-parallel from HBase: no single
process held the full event set.  The same here:

* **Shard the scan by entity hash**: each process calls
  :func:`find_columnar_sharded` and keeps only the events whose
  ``entity_id`` hashes (md5) into its shard, so a user's events land on
  one process and per-row preprocessing stays process-local.
* **Build one global id dictionary**: processes exchange their local
  unique ids through the shared storage directory and everyone builds
  the same sorted-unique :class:`StringIndex` (:func:`ids_exchange`).
* **Exchange the numeric COO by row owner**: each rating triple goes to
  the process whose shards solve its row
  (:func:`exchange_ratings_by_owner`, a file-based all-to-all over the
  shared storage tree), so no process holds the full COO
  (``models/als.py`` ``ALSTrainer.distributed``).  :func:`gather_ratings`
  remains for the replicated path.

Single-process runs short-circuit: shard 0 of 1 is the whole table and
the gathers are the identity.
"""

from __future__ import annotations

import hashlib
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .mesh import process_count as _process_count
from .mesh import process_index as _process_index

logger = logging.getLogger(__name__)

__all__ = [
    "entity_shard",
    "shard_mask",
    "find_columnar_sharded",
    "ids_exchange",
    "gather_ratings",
    "global_count",
    "exchange_ratings_by_owner",
    "read_ratings_distributed",
    "distributed_trainer",
    "ExchangeTornError",
]


class ExchangeTornError(RuntimeError):
    """The sharded-COO file exchange failed past its retry budget.

    Raised by :func:`exchange_ratings_by_owner` after the configured
    retries; :func:`distributed_trainer` catches it and degrades to the
    replicated gather path (correct, but rating memory no longer scales
    with the cluster) instead of dying mid-train."""


def entity_shard(entity_id: str, n_shards: int) -> int:
    """Stable shard of an entity id (md5-based, like the reference's
    event row key `storage/hbase/HBEventsUtil.scala:96-128`)."""
    h = hashlib.md5(entity_id.encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big") % n_shards


def shard_mask(entity_ids: np.ndarray, n_shards: int, shard_id: int) -> np.ndarray:
    """Boolean mask of the rows whose entity hashes into ``shard_id``.

    Hashes each UNIQUE id once and scatters by inverse index: event tables
    have many rows per entity, so hashing per-row would repeat the
    interpreter-level md5 N/U times for nothing.
    """
    if n_shards <= 1:
        return np.ones(len(entity_ids), dtype=bool)
    uniq, inv = np.unique(np.asarray(entity_ids), return_inverse=True)
    owners = np.fromiter(
        (entity_shard(str(e), n_shards) for e in uniq),
        dtype=np.int64,
        count=len(uniq),
    )
    return owners[inv] == shard_id


def find_columnar_sharded(
    es,
    n_shards: int,
    shard_id: int,
    **kwargs,
):
    """This process's shard of a columnar event scan.

    Generic implementation: full backend scan + entity-hash filter.  (A
    backend could push the predicate down; correctness is identical and the
    scan stays embarrassingly parallel either way.)
    """
    if not 0 <= shard_id < max(n_shards, 1):
        raise ValueError(f"shard_id {shard_id} out of range 0..{n_shards - 1}")
    frame = es.find_columnar(**kwargs)
    if n_shards <= 1:
        return frame
    return frame.select(shard_mask(frame.entity_id, n_shards, shard_id))


# --------------------------------------------------------------------------
# Global id dictionary via shared-directory exchange
# --------------------------------------------------------------------------

_STALE_AGE_S = 3600.0


def _sweep_stale(exchange_dir: Path, age_s: float = _STALE_AGE_S) -> None:
    """Best-effort removal of exchange files no live run can still want.

    Files from a crashed run (SIGKILL between publish and cleanup) or from
    explicit-topology callers (who have no barrier to clean up behind) are
    nonce- or caller-tagged and will never be matched again; anything older
    than ``age_s`` is dead weight in the shared storage tree.  Live runs
    are unaffected: their files are seconds old.
    """
    cutoff = time.time() - age_s
    try:
        for f in exchange_dir.glob("*.npz"):
            try:
                if f.stat().st_mtime < cutoff:
                    f.unlink(missing_ok=True)
            except OSError:
                continue
    except OSError:
        pass


def ids_exchange(
    local_ids: Sequence[str],
    exchange_dir,
    tag: str,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
    timeout: float = 120.0,
):
    """All processes contribute their local unique ids; everyone gets the
    same deterministic global :class:`StringIndex` (sorted unique union).

    Exchange rides the shared storage directory (every multi-host
    PredictionIO deployment shares its storage tree, as the reference shared
    HDFS/HBase); files are written atomically and polled with a timeout, so
    no collective is needed for the string payload.

    When the process topology comes from the process group (the default —
    ``process_id``/``process_count`` not given), the call is self-protecting
    against stale files: a run nonce broadcast from process 0 is folded into
    the file names, and every process deletes its own file after a global
    sync, so shard files left behind by a crashed earlier run with the same
    ``tag`` can never be merged into this run's union.  Callers that pass an
    explicit ``process_id``/``process_count`` (no process group to ride)
    must guarantee tag uniqueness per run themselves.
    """
    from ..storage.bimap import StringIndex

    managed = process_id is None and process_count is None
    pid = _process_index() if process_id is None else process_id
    n = _process_count() if process_count is None else process_count
    if n <= 1:
        return StringIndex.from_values(local_ids)
    if managed:
        tag = f"{tag}-{_run_nonce():016x}"

    exchange_dir = Path(exchange_dir)
    exchange_dir.mkdir(parents=True, exist_ok=True)
    # never sweep inside the window a live straggler could still publish in
    _sweep_stale(exchange_dir, age_s=max(_STALE_AGE_S, 2.0 * timeout))
    mine = exchange_dir / f"{tag}-{pid}.npz"
    # keep the .npz suffix on the temp name: np.savez appends it otherwise
    tmp = exchange_dir / f"{tag}-{pid}.tmp.npz"
    np.savez_compressed(
        tmp, ids=np.asarray(sorted(set(local_ids)), dtype=str)
    )
    tmp.rename(mine)  # atomic publish

    union: set[str] = set()
    deadline = time.time() + timeout
    try:
        for other in range(n):
            path = exchange_dir / f"{tag}-{other}.npz"
            while not path.exists():
                if time.time() > deadline:
                    raise TimeoutError(
                        f"ids_exchange: shard file {path} not published "
                        f"within {timeout}s"
                    )
                time.sleep(0.05)
            data = np.load(path, allow_pickle=False)
            union.update(data["ids"].tolist())
    except BaseException:
        # failed exchange: withdraw this process's file so it can't be
        # merged into (or leak from) a later run
        mine.unlink(missing_ok=True)
        raise
    if managed:
        # everyone has read every shard file; drop this process's own
        _barrier()
        mine.unlink(missing_ok=True)
    return StringIndex.from_values(union)


# --------------------------------------------------------------------------
# Numeric COO all-gather
# --------------------------------------------------------------------------


def _run_nonce() -> int:
    """A per-run nonce drawn by process 0 and broadcast to everyone."""
    import secrets

    import torch.distributed as dist

    box = [secrets.randbits(62)]
    dist.broadcast_object_list(box, src=0)
    return int(box[0])


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def _allgather_padded(arr: np.ndarray) -> np.ndarray:
    """Concatenate a per-process 1-D array across processes, in rank
    order (uneven sizes)."""
    import torch.distributed as dist

    got: list = [None] * _process_count()
    dist.all_gather_object(got, np.asarray(arr))
    return np.concatenate(got)


def global_count(n: int) -> int:
    """The sum of a per-process count over the run's processes."""
    if _process_count() <= 1:
        return int(n)
    import torch.distributed as dist

    got: list = [None] * _process_count()
    dist.all_gather_object(got, int(n))
    return int(sum(got))


def gather_ratings(ratings):
    """Union of every process's COO shard, on every process.

    Requires the shards to be encoded against the SAME global id index
    (see :func:`ids_exchange`); single-process is the identity.
    """
    from ..storage.columnar import Ratings

    if _process_count() <= 1:
        return ratings
    return Ratings(
        user_ix=_allgather_padded(ratings.user_ix),
        item_ix=_allgather_padded(ratings.item_ix),
        rating=_allgather_padded(ratings.rating),
        users=ratings.users,
        items=ratings.items,
    )


def _exchange_all_to_all(
    exchange_dir,
    tag: str,
    payloads: dict[int, dict[str, np.ndarray]],
    timeout: float = 120.0,
) -> list[dict]:
    """File-based all-to-all over the shared storage tree.

    Every process writes one npz per destination process (EVERY
    destination, even when empty — absence must mean "not published yet",
    never "nothing to send") and reads the files addressed to it.  Same
    self-protection as :func:`ids_exchange`: per-run nonce from process 0
    folded into filenames, post-sync cleanup of own files, withdrawal on
    failure.  Returns the loaded dicts ordered by source process.
    """
    pid, n = _process_index(), _process_count()
    tag = f"{tag}-{_run_nonce():016x}"
    exchange_dir = Path(exchange_dir)
    exchange_dir.mkdir(parents=True, exist_ok=True)
    _sweep_stale(exchange_dir, age_s=max(_STALE_AGE_S, 2.0 * timeout))
    from ..resilience import faults

    mine: list[Path] = []
    try:
        for dst in range(n):
            # dist.exchange_torn: a publish tears mid-exchange — the
            # except-path below withdraws the files already published,
            # exactly what a crashed real peer forces survivors to do
            faults.check("dist.exchange_torn")
            path = exchange_dir / f"{tag}-{pid}to{dst}.npz"
            tmp = exchange_dir / f"{tag}-{pid}to{dst}.tmp.npz"
            # uncompressed on purpose: this path exists for bulk numeric
            # COO payloads, where single-threaded deflate would dominate
            # the exchange wall-clock for little ratio (int32/f32 rating
            # triples compress poorly); the small string id exchange
            # keeps compression
            np.savez(tmp, **payloads.get(dst, {}))
            tmp.rename(path)  # atomic publish
            mine.append(path)
        out = []
        deadline = time.time() + timeout
        for src in range(n):
            path = exchange_dir / f"{tag}-{src}to{pid}.npz"
            while not path.exists():
                if time.time() > deadline:
                    raise TimeoutError(
                        f"exchange: shard file {path} not published "
                        f"within {timeout}s"
                    )
                time.sleep(0.05)
            with np.load(path, allow_pickle=False) as data:
                out.append({k: data[k] for k in data.files})
    except BaseException:
        for p in mine:
            p.unlink(missing_ok=True)
        raise
    _barrier()
    for p in mine:
        p.unlink(missing_ok=True)
    return out


def exchange_ratings_by_owner(
    row_ix: np.ndarray,
    col_ix: np.ndarray,
    rating: np.ndarray,
    owner_of_row: np.ndarray,
    exchange_dir,
    tag: str,
    timeout: float = 120.0,
    retry=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Send each rating triple to the process owning its ROW and return
    the triples this process received (concatenated over sources).

    ``owner_of_row[r]`` names the destination process of row ``r``
    (derived from the shard plan's row→device map plus the mesh's
    device→process map; called once per ALS side with that side's row
    ids).  The multi-host replacement for :func:`gather_ratings`:
    afterwards each process holds exactly the ratings its devices solve
    — cluster rating capacity scales with the number of hosts instead of
    being capped by one host's memory, the way the reference's
    region-sharded HBase scan never materialized the full event set in
    one JVM (`storage/hbase/HBPEvents.scala:99-105`).

    A torn exchange (``dist.exchange_torn`` injection, a crashed peer's
    half-published files, a flaky shared filesystem) is retried whole —
    each attempt re-publishes under a fresh nonce, so a retry can never
    merge a previous attempt's partial files.  Retries stay in lockstep
    across processes for deterministic (plan-armed) faults because every
    process consults the same ``PIO_FAULT_PLAN``; a genuinely one-sided
    failure surfaces as a timeout on the survivors, which the same
    retry covers.  Past the budget the call raises
    :class:`ExchangeTornError` — callers with a fallback (see
    :func:`distributed_trainer`) degrade instead of hanging.
    """
    from ..obs import RESILIENCE_TOTAL
    from ..resilience import RetryPolicy, faults

    n = _process_count()
    if retry is None:
        retry = RetryPolicy(max_attempts=2, base_s=0.05, seed=0)

    def attempt():
        # consulted before the single-process short-circuit so the
        # torn-exchange semantics are testable on the simulated cluster
        faults.check("dist.exchange_torn")
        if n <= 1:
            return row_ix, col_ix, rating
        dest = np.asarray(owner_of_row)[row_ix]
        payloads = {}
        for dst in range(n):
            sel = dest == dst
            payloads[dst] = {
                "r": np.ascontiguousarray(row_ix[sel]),
                "c": np.ascontiguousarray(col_ix[sel]),
                "v": np.ascontiguousarray(rating[sel]),
            }
        got = _exchange_all_to_all(
            exchange_dir, tag, payloads, timeout=timeout
        )
        return (
            np.concatenate([g["r"] for g in got]),
            np.concatenate([g["c"] for g in got]),
            np.concatenate([g["v"] for g in got]),
        )

    def on_retry(attempt_no, exc):
        RESILIENCE_TOTAL.labels(kind="dist.exchange_retry").inc()
        logger.warning(
            "COO exchange %s torn (attempt %d: %s); retrying under a "
            "fresh nonce", tag, attempt_no, exc,
        )

    retriable = (faults.InjectedFault, OSError, TimeoutError)
    try:
        return retry.call(attempt, retry_on=retriable, on_retry=on_retry)
    except retriable as e:
        raise ExchangeTornError(
            f"COO exchange {tag!r} failed past its retry budget: {e}"
        ) from e


def read_ratings_distributed(
    es,
    exchange_dir,
    tag: str = "ratings",
    rating_property: Optional[str] = None,
    dedup: str = "last",
    gather: bool = True,
    **scan_kwargs,
):
    """End-to-end multi-host training-data read: sharded scan -> global id
    dictionaries -> globally-encoded COO -> all-gathered ratings.

    ``gather=False`` skips the final all-gather and returns each
    process's LOCAL shard (still encoded against the global id index) —
    the input :meth:`ALSTrainer.distributed` wants, for trains whose
    rating set must never be resident on one host.

    Single-process: equivalent to ``es.find_columnar(...).to_ratings(...)``.
    """
    n, pid = _process_count(), _process_index()
    frame = find_columnar_sharded(
        es, n_shards=n, shard_id=pid,
        float_property=rating_property,
        minimal=True,   # only to_ratings fields are consumed downstream
        **scan_kwargs,
    )
    # ids_exchange self-protects against stale files (per-run nonce +
    # post-sync cleanup) on the process-group path used here
    users = ids_exchange(
        frame.entity_id.tolist(), exchange_dir, f"{tag}-users"
    )
    items = ids_exchange(
        frame.target_entity_id.tolist(), exchange_dir, f"{tag}-items"
    )
    local = frame.to_ratings(
        rating_property=rating_property,
        user_index=users,
        item_index=items,
        dedup=dedup,
    )
    return gather_ratings(local) if gather else local


def distributed_trainer(
    es,
    exchange_dir,
    cfg,
    mesh,
    tag: str = "ratings",
    rating_property: Optional[str] = None,
    dedup: str = "last",
    timeout: float = 120.0,
    **scan_kwargs,
):
    """End-to-end multi-process sharded training-data read.

    sharded scan -> global id dictionaries -> locally-encoded COO ->
    row-owner exchange -> :meth:`~..models.als.ALSTrainer.distributed`
    over the sharded-COO layout on ``mesh``.  No process holds the full
    rating set.  Single-process degenerates to the plain trainer; a
    torn exchange past its retries degrades to the replicated trainer on
    the gathered ratings, booked as ``dist.exchange_degraded``.
    """
    from ..models.als import ALSTrainer

    n, pid = _process_count(), _process_index()
    frame = find_columnar_sharded(
        es, n_shards=n, shard_id=pid,
        float_property=rating_property,
        minimal=True,
        **scan_kwargs,
    )
    users = ids_exchange(
        frame.entity_id.tolist(), exchange_dir, f"{tag}-users"
    )
    items = ids_exchange(
        frame.target_entity_id.tolist(), exchange_dir, f"{tag}-items"
    )
    local = frame.to_ratings(
        rating_property=rating_property,
        user_index=users,
        item_index=items,
        dedup=dedup,
    )
    try:
        return ALSTrainer.distributed(
            local, cfg=cfg, mesh=mesh, exchange_dir=exchange_dir,
            tag=f"{tag}-coo", timeout=timeout,
        )
    except ExchangeTornError as e:
        # retry budget spent: degrade LOUDLY to the replicated gather
        # path — the train still completes and the model is identical,
        # but rating memory no longer scales with the cluster, so the
        # degradation is booked where operators look
        import dataclasses

        from ..obs import RESILIENCE_TOTAL

        RESILIENCE_TOTAL.labels(kind="dist.exchange_degraded").inc()
        logger.error(
            "sharded-COO exchange failed past retries (%s); degrading "
            "to the replicated gather path — rating memory will NOT "
            "scale with the cluster this run", e,
        )
        gathered = gather_ratings(local)
        cfg_rep = dataclasses.replace(
            cfg, factor_placement="replicated", coded_shards=False
        )
        return ALSTrainer(gathered, cfg=cfg_rep, mesh=mesh)
