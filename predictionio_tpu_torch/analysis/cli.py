"""piolint command line: file discovery, engines, baseline, output,
exit code.

The reference's ``predictionio_tpu/analysis/cli.py`` over this package.
``python -m predictionio_tpu_torch.analysis [paths...]`` with no paths
scans the gate scope — ``predictionio_tpu_torch/``, ``chip_smoke.py``
and ``kernel_variants.py`` relative to the repo root.  Exit code is 1
iff any finding is neither inline-suppressed nor baselined (``--strict`` ignores the baseline, for
periodic full-debt review, and additionally requires a written
``justification`` on every baselined PIO21x deadlock entry).

Per-file engines (torch/time/async/lock/engine-import) run on each file
independently; the whole-program engines (deadlock PIO21x, contract
PIO4xx) run once over the full analyzed set — ``analyze_paths`` is the
program boundary, so fixtures passed as a single path form a one-file
program and the gate's default scope forms the real one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Optional

from .asynclint import AsyncEngine
from .contractlint import ContractEngine
from .core import RULES, Baseline, Finding, SourceFile, load_baseline
from .deadlint import DeadlockEngine
from .enginelint import EngineImportEngine
from .locklint import LockEngine
from .timelint import TimeEngine
from .torchlint import TorchEngine

__all__ = ["analyze_file", "analyze_paths", "repo_root", "main"]

# inside the package, so that each slice of the port keeps its own
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"
# PIO108's scope: the scripts every figure of the port comes from
BENCH_FILES = ("chip_smoke.py", "kernel_variants.py")
PACKAGE = "predictionio_tpu_torch"

# rule prefix -> engine bucket for the per-engine summary counts
ENGINE_BUCKETS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("parse", ("PIO100",)),
    ("torch", ("PIO101", "PIO102", "PIO103", "PIO104", "PIO105",
             "PIO106", "PIO107", "PIO108")),
    ("time", ("PIO109",)),
    ("async", ("PIO110",)),
    ("lock", ("PIO201", "PIO202", "PIO203")),
    ("deadlock", ("PIO210", "PIO211", "PIO212", "PIO213")),
    ("engine", ("PIO301",)),
    ("contract", ("PIO401", "PIO402", "PIO403")),
)

# deliberately-violating analyzer test inputs: never scanned implicitly
# (the tests run the engines on them directly); passing one as an
# explicit single-file argument still works
EXCLUDED_DIR_PARTS = ("piolint_fixtures",)


def _excluded(path: Path) -> bool:
    return any(part in EXCLUDED_DIR_PARTS for part in path.parts)


def repo_root() -> Path:
    """The directory holding the ``predictionio_tpu_torch`` package."""
    return Path(__file__).resolve().parent.parent.parent


def _is_bench_scope(path: Path, root: Path) -> bool:
    """PIO108 (timing-span) scope: ``chip_smoke.py`` and
    ``kernel_variants.py`` at the repo root."""
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        rel = Path(path.name)
    return rel.as_posix() in BENCH_FILES


def _is_engine_scope(path: Path, root: Path) -> bool:
    """PIO301 (engine isolation) scope: engine template modules —
    ``predictionio_tpu_torch/templates/*.py`` minus ``_``-prefixed
    infrastructure files (``_common.py`` wraps platform utilities for
    engines; it IS the sanctioned boundary)."""
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        return False
    return (
        len(rel.parts) == 3
        and rel.parts[0] == PACKAGE
        and rel.parts[1] == "templates"
        and not rel.name.startswith("_")
    )


def _is_pkg_scope(path: Path, root: Path) -> bool:
    """PIO109 (wall-clock duration) scope: the package itself.  The
    measurement scripts keep wall clocks (fenced, coarse — PIO108 covers
    their honesty); production code must not."""
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        return False
    return len(rel.parts) > 1 and rel.parts[0] == PACKAGE


def default_paths(root: Optional[Path] = None) -> list[Path]:
    root = root or repo_root()
    paths: list[Path] = sorted((root / PACKAGE).rglob("*.py"))
    return paths + [root / f for f in BENCH_FILES if (root / f).is_file()]


def changed_paths(root: Optional[Path] = None) -> list[Path]:
    """Python files currently staged in the git index (pre-commit scope).

    Uses ``--name-status -z``: NUL-separated and never C-quoted, so
    renames (``R`` status — take the DESTINATION path, the side that
    exists in the index) and non-ASCII names survive; plain
    ``--name-only`` output C-quotes unusual names into strings that
    fail the existence check and silently drop the file."""
    root = root or repo_root()
    try:
        out = subprocess.run(
            ["git", "diff", "--cached", "--name-status", "-z",
             "--diff-filter=ACMR"],
            cwd=root, capture_output=True, check=True,
        ).stdout.decode("utf-8", "surrogateescape")
    except (OSError, subprocess.CalledProcessError):
        return []
    paths = []
    toks = out.split("\0")
    i = 0
    while i < len(toks):
        status = toks[i].strip()
        if not status:
            i += 1
            continue
        if status[0] in ("R", "C"):
            # "R<score> NUL old NUL new": the destination is staged
            name = toks[i + 2] if i + 2 < len(toks) else ""
            i += 3
        else:
            name = toks[i + 1] if i + 1 < len(toks) else ""
            i += 2
        p = root / name
        if p.suffix == ".py" and p.exists() and not _excluded(p):
            paths.append(p)
    return paths


def _load(path: Path, root: Path):
    """(SourceFile, None) or (None, PIO100 Finding)."""
    try:
        return SourceFile.load(path, root), None
    except (SyntaxError, UnicodeDecodeError, ValueError, OSError) as e:
        # a file the gate scans but can't read or parse IS a finding
        return None, Finding(
            rule="PIO100", path=str(path), line=getattr(e, "lineno", 1) or 1,
            col=0, message=f"file does not parse: {e}", scope="",
            snippet="",
        )


def _file_findings(src: SourceFile, path: Path,
                   root: Path) -> list[Finding]:
    findings = TorchEngine(
        src, bench_scope=_is_bench_scope(path, root)
    ).run()
    findings += LockEngine(src).run()
    findings += AsyncEngine(src).run()
    if _is_pkg_scope(path, root):
        findings += TimeEngine(src).run()
    if _is_engine_scope(path, root):
        findings += EngineImportEngine(src).run()
    return findings


def analyze_file(path: Path, root: Optional[Path] = None) -> list[Finding]:
    """Run the per-file engines over one file (the whole-program
    deadlock/contract engines need the full set — use analyze_paths)."""
    root = root or repo_root()
    src, err = _load(path, root)
    if src is None:
        return [err]
    return _file_findings(src, path, root)


def analyze_paths(paths: list[Path],
                  root: Optional[Path] = None) -> list[Finding]:
    """Per-file engines on each path, then the whole-program engines
    (deadlock PIO21x, contract PIO4xx) over the parsed set."""
    root = root or repo_root()
    findings: list[Finding] = []
    srcs: list[SourceFile] = []
    for p in paths:
        src, err = _load(p, root)
        if src is None:
            findings.append(err)
            continue
        srcs.append(src)
        findings += _file_findings(src, p, root)
    findings += DeadlockEngine(srcs).run()
    findings += ContractEngine(srcs, root).run()
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _report_json(findings: list[Finding], strict: bool) -> dict:
    active = [f for f in findings if strict or not f.baselined]
    return {
        "version": 1,
        "strict": strict,
        "rules": RULES,
        "counts": {
            "total": len(findings),
            "baselined": sum(f.baselined for f in findings),
            "active": len(active),
        },
        "engines": _engine_counts(findings),
        "findings": [f.to_json() for f in findings],
    }


def _engine_counts(findings: list[Finding]) -> dict[str, int]:
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        engine: sum(by_rule.get(r, 0) for r in rules)
        for engine, rules in ENGINE_BUCKETS
    }


def _report_sarif(findings: list[Finding]) -> dict:
    """SARIF 2.1.0: one run, every finding a result; baselined ones
    carry an external suppression so annotators can dim them."""
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "warning" if f.baselined else "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {
                        "startLine": f.line,
                        "startColumn": f.col + 1,
                    },
                },
            }],
        }
        if f.baselined:
            result["suppressions"] = [{"kind": "external"}]
        results.append(result)
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "piolint-torch",
                    "rules": [
                        {"id": code,
                         "shortDescription": {"text": RULES[code]}}
                        for code in sorted(RULES)
                    ],
                },
            },
            "results": results,
        }],
    }


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.analysis",
        description="piolint: torch-aware static analysis, lock-discipline, "
                    "deadlock, and contract-drift checker "
                    "(rules PIO1xx/PIO2xx/PIO3xx/PIO4xx)",
    )
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files or directories to analyze (default: the "
                         "gate scope — predictionio_tpu_torch/, "
                         "chip_smoke.py, kernel_variants.py)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline file (default: "
                         "predictionio_tpu_torch/analysis/baseline.json)")
    ap.add_argument("--strict", action="store_true",
                    help="ignore the baseline: every finding fails, and "
                         "every baselined PIO21x deadlock entry must "
                         "carry a written justification "
                         "(periodic full-debt review)")
    ap.add_argument("--changed-files", action="store_true",
                    help="analyze only .py files staged in the git index "
                         "(pre-commit mode); overrides positional paths")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline "
                         "file and exit 0")
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(RULES):
            print(f"{code}  {RULES[code]}")
        return 0

    root = repo_root()
    if args.changed_files:
        paths = changed_paths(root)
        if not paths:
            print("piolint: no staged python files; nothing to do")
            return 0
    elif args.paths:
        paths = []
        for p in args.paths:
            if p.is_dir():
                paths += sorted(q for q in p.rglob("*.py")
                                if not _excluded(q))
            else:
                paths.append(p)
    else:
        paths = default_paths(root)

    t0 = time.perf_counter()
    findings = analyze_paths(paths, root)
    elapsed = time.perf_counter() - t0

    baseline_path = args.baseline or BASELINE_PATH
    if args.write_baseline:
        Baseline.from_findings(findings).save(baseline_path)
        print(f"piolint: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    if args.strict:
        # a baselined deadlock hazard without a written reason is just
        # a muted bug: --strict refuses to review around it
        missing = [
            e for e in baseline.entries
            if e.get("rule", "").startswith("PIO21")
            and not str(e.get("justification", "")).strip()
        ]
        if missing:
            for e in missing:
                print(f"piolint: baseline entry {e.get('path')} "
                      f"{e.get('rule')} [{e.get('scope')}] lacks the "
                      "justification required for PIO21x entries")
            return 1
    baseline.apply(findings)
    active = [f for f in findings if args.strict or not f.baselined]

    report = _report_json(findings, args.strict)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=2) + "\n")

    if args.format == "json":
        print(json.dumps(report, indent=2))
    elif args.format == "sarif":
        print(json.dumps(_report_sarif(findings), indent=2))
    else:
        for f in findings:
            if f.baselined and not args.strict:
                continue
            print(f.text())
        n_base = report["counts"]["baselined"]
        per_engine = " | ".join(
            f"{name} {count}"
            for name, count in report["engines"].items())
        print(f"piolint: {len(paths)} file(s), {len(active)} active "
              f"finding(s), {n_base} baselined "
              f"[{per_engine}] in {elapsed:.1f}s"
              + (" (strict: baseline ignored)" if args.strict else ""))
    return 1 if active else 0
