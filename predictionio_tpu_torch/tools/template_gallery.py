"""Template gallery: `pio template list|get`.

Port of ``predictionio_tpu/tools/template_gallery.py``.  The reference
(`tools/console/Template.scala:130-427`) browses a GitHub gallery,
downloads a release zip, rewrites the Scala package name, and records
`template.json` metadata; `verifyTemplateMinVersion` (`:417-427`) gates
`train`/`deploy` on the template's declared minimum framework version.
Here the gallery is the set of engines the port registers
(``engines``), and `template get` scaffolds a self-contained engine
directory — `engine.py` re-exporting the port's components,
`engine.json` variant, `template.json` metadata, README — that the
port's `train`/`deploy` consume directly.  An archive may come from a
local file (``--from-archive``) or an operator-given URL
(``--from-url``, ``--index-url``); either is untrusted input, extracted
with the hardening of :func:`scaffold_from_archive`.
"""

from __future__ import annotations

import json
import stat
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .. import __version__

__all__ = [
    "GALLERY",
    "TemplateMeta",
    "fetch_index",
    "list_templates",
    "scaffold",
    "scaffold_from_archive",
    "scaffold_from_index",
    "scaffold_from_url",
    "verify_template_min_version",
    "TemplateVersionError",
]

# remote-fetch guardrails: templates are untrusted input arriving over
# the operator-supplied URL, so the transport is capped before the
# archive hardening in _extract_archive even starts
_MAX_INDEX_BYTES = 4 << 20     # a template INDEX beyond 4 MB is wrong
_MAX_ARCHIVE_BYTES = 256 << 20
_ARCHIVE_SUFFIXES = (".zip", ".tar", ".tar.gz", ".tgz")


@dataclass(frozen=True)
class TemplateMeta:
    name: str
    description: str
    factory: str                     # dotted path to the engine factory
    engine_params: dict = field(default_factory=dict)
    query_example: dict = field(default_factory=dict)


class _Gallery(dict):
    """The template gallery is a view of the engine registry: one
    :class:`~predictionio_tpu_torch.engines.EngineSpec` declaration per
    engine feeds both ``engines list`` and ``template list/get``.

    Built lazily on first access so importing this module does not pull
    the template modules (and torch) for commands that never touch the
    gallery; refreshed from the registry on every build so engines
    registered later (``PIO_TPU_ENGINE_PATH``) appear."""

    _built = False

    def _build(self) -> None:
        from ..engines import list_engine_specs

        self.clear()
        for spec in list_engine_specs():
            self[spec.name] = TemplateMeta(
                name=spec.name,
                description=spec.description,
                factory=spec.factory_path,
                engine_params=dict(spec.default_params),
                query_example=dict(spec.query_example),
            )
        self._built = True

    def _ensure(self) -> None:
        if not self._built:
            self._build()

    def __getitem__(self, k):
        self._ensure()
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._ensure()
        return super().get(k, default)

    def __iter__(self):
        self._ensure()
        return super().__iter__()

    def __len__(self) -> int:
        self._ensure()
        return super().__len__()

    def __contains__(self, k) -> bool:
        self._ensure()
        return super().__contains__(k)

    def values(self):
        self._ensure()
        return super().values()

    def keys(self):
        self._ensure()
        return super().keys()

    def items(self):
        self._ensure()
        return super().items()


GALLERY: dict[str, TemplateMeta] = _Gallery()


def list_templates() -> list[TemplateMeta]:
    GALLERY._build()  # refresh: late registrations must appear
    return list(GALLERY.values())


_ENGINE_PY = '''\
"""Engine scaffolded from the built-in `{name}` template.

Customize by subclassing the imported components (the reference's
`template get` rewrites a downloaded Scala project; here the framework
components are imported and re-exported so the engine.json stays small).
"""

from {module} import *  # noqa: F401,F403
from {module} import {attr} as engine_factory  # noqa: F401
'''

_README = """\
# {name} (predictionio_tpu_torch template)

{description}

## Usage

    python -m predictionio_tpu_torch app new MyApp     # app + access key
    python -m predictionio_tpu_torch import --appid <id> --input events.jsonl
    python -m predictionio_tpu_torch build             # register the engine
    python -m predictionio_tpu_torch train             # train on the GPU
    python -m predictionio_tpu_torch deploy --port 8000  # serve queries.json

Query example:

    curl -H 'Content-Type: application/json' \\
         -d '{query}' http://localhost:8000/queries.json
"""


def scaffold(template_name: str, target_dir: str | Path) -> Path:
    """`pio template get` analogue: write a runnable engine directory."""
    meta = GALLERY.get(template_name)
    if meta is None:
        raise KeyError(
            f"unknown template {template_name!r}; "
            f"available: {', '.join(sorted(GALLERY))}"
        )
    target = Path(target_dir)
    if target.exists() and any(target.iterdir()):
        raise FileExistsError(f"target directory {target} is not empty")
    target.mkdir(parents=True, exist_ok=True)

    module, _, attr = meta.factory.rpartition(".")
    (target / "engine.py").write_text(
        _ENGINE_PY.format(name=meta.name, module=module, attr=attr)
    )
    # engineFactory points at the scaffolded engine.py (resolved relative
    # to the engine dir by the workflow loader), so user edits there take
    # effect — pointing at the built-in factory would make the file dead.
    variant = {
        "id": meta.name,
        "description": meta.description,
        "engineFactory": "engine.engine_factory",
        **meta.engine_params,
    }
    (target / "engine.json").write_text(json.dumps(variant, indent=2) + "\n")
    # template.json: min-version metadata (Template.scala:417-427 analogue)
    (target / "template.json").write_text(
        json.dumps({"pio": {"version": {"min": __version__}}}, indent=2)
        + "\n"
    )
    (target / "README.md").write_text(
        _README.format(
            name=meta.name,
            description=meta.description,
            query=json.dumps(meta.query_example),
        )
    )
    return target


def _http_get(url: str, max_bytes: int, timeout: float,
              sink=None) -> Optional[bytes]:
    """Streamed GET with a scheme check and a hard size cap (a
    mis-pointed URL must fail fast, not fill the disk).  With ``sink``
    (a writable binary file object) chunks stream straight to it and
    None is returned — archives up to the 256 MB cap never sit in
    memory; without it the body is returned as bytes (small indexes)."""
    import urllib.request
    from urllib.parse import urlparse

    scheme = urlparse(url).scheme
    if scheme not in ("http", "https"):
        raise ValueError(
            f"unsupported URL scheme {scheme!r} for {url!r} "
            "(http/https only)"
        )
    req = urllib.request.Request(
        url, headers={"User-Agent": f"pio-tpu-torch/{__version__}"}
    )
    chunks, size = [], 0
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            if size > max_bytes:
                raise ValueError(
                    f"download of {url!r} exceeded the {max_bytes} byte "
                    "cap; refusing"
                )
            if sink is not None:
                sink.write(chunk)
            else:
                chunks.append(chunk)
    if sink is not None:
        sink.flush()
        return None
    return b"".join(chunks)


def fetch_index(index_url: str, timeout: float = 20.0) -> list[dict]:
    """Browse a remote template index — the HTTP half of the
    reference's gallery browse (`tools/console/Template.scala:130-170`,
    which lists a GitHub repository; here the index is framework-
    neutral JSON so any static file server can host a gallery).

    Accepts either a bare JSON list or ``{"templates": [...]}``; each
    entry is a dict with at least ``name`` and ``url`` (archive
    location, absolute or relative to the index URL) and optionally
    ``description``.
    """
    raw = _http_get(index_url, _MAX_INDEX_BYTES, timeout)
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"template index at {index_url!r} is not JSON: {e}")
    entries = doc.get("templates") if isinstance(doc, dict) else doc
    if not isinstance(entries, list):
        raise ValueError(
            f"template index at {index_url!r} must be a JSON list or "
            "{'templates': [...]}"
        )
    out = []
    for e in entries:
        if (
            not isinstance(e, dict)
            or not isinstance(e.get("name"), str)
            or not isinstance(e.get("url"), str)
            or not isinstance(e.get("description", ""), str)
        ):
            # untrusted input: a non-string url/name would otherwise
            # surface later as a raw TypeError from urljoin/formatting
            raise ValueError(
                f"template index entry {e!r} needs string 'name' and "
                "'url' (and a string 'description' if present)"
            )
        out.append(e)
    return out


def scaffold_from_url(url: str, target_dir: str | Path,
                      timeout: float = 60.0) -> Path:
    """Download an engine archive over HTTP(S), then run the SAME
    hardened extract-and-validate flow as a local archive — the
    download half of `tools/console/Template.scala:171-300` (fetch
    release archive -> extract -> record metadata).  The transport adds
    nothing to trust: size-capped fetch into a temp file, then every
    local-archive check (member paths, links, engine.json presence,
    min-version gate) applies unchanged."""
    import tempfile
    from urllib.parse import urlparse

    path = urlparse(url).path.lower()
    suffix = next(
        (s for s in _ARCHIVE_SUFFIXES if path.endswith(s)), None
    )
    if suffix is None:
        raise ValueError(
            f"cannot tell the archive type of {url!r} "
            f"(expected a path ending in one of {_ARCHIVE_SUFFIXES})"
        )
    # a doomed scaffold must not pull the archive first
    target = Path(target_dir)
    if target.exists() and any(target.iterdir()):
        raise FileExistsError(f"target directory {target} is not empty")
    with tempfile.NamedTemporaryFile(suffix=suffix) as tmp:
        _http_get(url, _MAX_ARCHIVE_BYTES, timeout, sink=tmp)
        return scaffold_from_archive(tmp.name, target_dir)


def scaffold_from_index(name: str, target_dir: str | Path,
                        index_url: str, timeout: float = 60.0) -> Path:
    """``template get NAME --index-url``: look the name up in the
    remote index, resolve its (possibly relative) archive URL, fetch,
    extract."""
    from urllib.parse import urljoin

    entries = fetch_index(index_url, timeout=timeout)
    by_name = {e["name"]: e for e in entries}
    if name not in by_name:
        raise KeyError(
            f"template {name!r} not in index {index_url!r}; "
            f"available: {', '.join(sorted(by_name)) or '(none)'}"
        )
    return scaffold_from_url(
        urljoin(index_url, by_name[name]["url"]), target_dir,
        timeout=timeout,
    )


def scaffold_from_archive(archive: str | Path, target_dir: str | Path) -> Path:
    """Scaffold an engine directory from a LOCAL zip/tar archive.

    The egress-free half of the reference's template download
    (`tools/console/Template.scala:171-300`: fetch GitHub release
    archive, extract, record metadata) — the fetch itself is out of
    scope in a zero-egress deployment, but a user with an archive in
    hand (shared drive, artifact store, `git archive` of a colleague's
    engine) gets the same extract-and-validate flow:

    * zip / tar / tar.gz / tgz by extension;
    * member paths are validated — absolute paths, ``..`` traversal,
      and symlink/hardlink members are rejected (the archive is
      untrusted input; links could point outside the target);
    * a single GitHub-style top-level directory is stripped;
    * the result must contain ``engine.json`` (otherwise it is not a
      runnable engine dir and the scaffold fails with the member list);
    * ``template.json`` min-version metadata is honored if present
      (checked now, and again by train/deploy) and created pinning the
      current version if absent;
    * extraction happens in a scratch dir renamed into place on
      success — a rejected archive leaves no partial target behind, so
      the user's retry after fixing it doesn't hit "not empty".
    """
    import shutil
    import tempfile

    archive = Path(archive)
    if not archive.exists():
        raise FileNotFoundError(f"archive not found: {archive}")
    target = Path(target_dir)
    if target.exists() and any(target.iterdir()):
        raise FileExistsError(f"target directory {target} is not empty")
    target.parent.mkdir(parents=True, exist_ok=True)
    scratch = Path(tempfile.mkdtemp(
        prefix=f".{target.name}.extract-", dir=target.parent
    ))
    try:
        _extract_archive(archive, scratch)

        # strip a single GitHub-style top-level directory
        entries = list(scratch.iterdir())
        if len(entries) == 1 and entries[0].is_dir():
            inner = entries[0]
            for child in list(inner.iterdir()):
                child.rename(scratch / child.name)
            inner.rmdir()

        if not (scratch / "engine.json").exists():
            found = sorted(
                str(p.relative_to(scratch)) for p in scratch.rglob("*")
            )[:20]
            raise ValueError(
                f"archive {archive.name} does not contain an engine.json "
                f"at its root — not an engine template (contents: {found})"
            )
        tj = scratch / "template.json"
        if not tj.exists():
            tj.write_text(
                json.dumps(
                    {"pio": {"version": {"min": __version__}}}, indent=2
                )
                + "\n"
            )
        verify_template_min_version(scratch)
        if target.exists():  # pre-existing EMPTY dir: replace it
            target.rmdir()
        scratch.rename(target)
    except Exception:
        shutil.rmtree(scratch, ignore_errors=True)
        raise
    return target


def _extract_archive(archive: Path, dest: Path) -> None:
    name = archive.name.lower()
    if name.endswith(".zip"):
        import zipfile

        with zipfile.ZipFile(archive) as zf:
            infos = [m for m in zf.infolist()
                     if not m.filename.endswith("/")]
            # zip stores unix mode bits in the high 16 of external_attr;
            # a symlink entry would otherwise materialize as a regular
            # file holding the link target — reject like the tar path
            for m in infos:
                if stat.S_ISLNK(m.external_attr >> 16):
                    raise ValueError(
                        f"archive {archive.name} contains link member "
                        f"{m.filename!r}; refusing to extract"
                    )
            _check_members([m.filename for m in infos], archive)
            for m in infos:
                out = dest / m.filename
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_bytes(zf.read(m))
    elif name.endswith((".tar", ".tar.gz", ".tgz")):
        import tarfile

        with tarfile.open(archive) as tf:
            infos = tf.getmembers()
            # links are rejected, not silently dropped: a skipped member
            # would surface much later as a missing file at train time
            for m in infos:
                if m.issym() or m.islnk():
                    raise ValueError(
                        f"archive {archive.name} contains link member "
                        f"{m.name!r}; refusing to extract"
                    )
            files = [m for m in infos if m.isfile()]
            _check_members([m.name for m in files], archive)
            for m in files:
                out = dest / m.name
                out.parent.mkdir(parents=True, exist_ok=True)
                f = tf.extractfile(m)
                assert f is not None
                out.write_bytes(f.read())
    else:
        raise ValueError(
            f"unsupported archive type {archive.name!r} "
            "(expected .zip, .tar, .tar.gz or .tgz)"
        )


def _check_members(names: list[str], archive: Path) -> None:
    """Reject absolute / traversal member paths (untrusted archives).

    Split on BOTH separators, not the host convention: on POSIX,
    ``Path('..\\x')`` is one component, so a Windows-style traversal
    member would pass a pathlib-only check (harmless here, traversal if
    this ever runs on Windows).  Drive-letter prefixes likewise."""
    for m in names:
        parts = m.replace("\\", "/").split("/")
        if (
            m.startswith(("/", "\\"))
            or ".." in parts
            # Windows drive prefix: single letter + ':' at the START
            # only — a POSIX member like '10:30.txt' or 'ab:c' stays
            # extractable; 'c:…' is rejected as a possible drive path
            or (len(m) >= 2 and m[0].isalpha() and m[1] == ":")
        ):
            raise ValueError(
                f"archive {archive.name} contains unsafe member path "
                f"{m!r}; refusing to extract"
            )


class TemplateVersionError(RuntimeError):
    pass


def _ver_tuple(v: str) -> tuple[int, ...]:
    parts = []
    for p in v.split("."):
        digits = "".join(c for c in p if c.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def verify_template_min_version(engine_dir: str | Path) -> None:
    """Raise if template.json declares a min version newer than ours."""
    tj = Path(engine_dir) / "template.json"
    if not tj.exists():
        return
    try:
        meta = json.loads(tj.read_text())
        min_v = meta["pio"]["version"]["min"]
    except (ValueError, KeyError, TypeError):
        return
    if _ver_tuple(str(min_v)) > _ver_tuple(__version__):
        raise TemplateVersionError(
            f"template requires predictionio_tpu_torch >= {min_v}, "
            f"this is {__version__}"
        )
