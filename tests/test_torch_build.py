"""The kernel builder's bookkeeping, on the host: with a stand-in ``nvcc``
(a shell script that records its calls and writes its ``-o`` file),
builds that start at once compile each source once and link once, and
an up-to-date build is reused; launches from many threads at once are
each counted (the entry point faked)."""

import os
import re
import stat
import struct
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from predictionio_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
sleep 0.2
echo built > "$out"
"""


def _fake_toolkit(tmp_path, monkeypatch):
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return log


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    log = _fake_toolkit(tmp_path, monkeypatch)
    paths, errors = [], []

    def run():
        try:
            paths.append(_build.build())
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    lib = tmp_path / "build" / _build.LIB_NAME
    assert paths == [lib] * 4
    calls = log.read_text().splitlines()
    n_src = len(_build._sources())
    assert sum(" -c " in c for c in calls) == n_src
    assert sum("-shared" in c for c in calls) == 1
    assert lib.read_text() == "built\n"
    assert (tmp_path / "build" / "sources.sha256").read_text() == \
        _build._source_hash()

    # up to date: reused without a call; force: built again
    _build.build()
    assert len(log.read_text().splitlines()) == n_src + 1
    _build.build(force=True)
    assert len(log.read_text().splitlines()) == 2 * (n_src + 1)
    assert not os.path.exists(tmp_path / "build" / (_build.LIB_NAME + ".tmp"))


def _expand(fmt: str) -> str:
    """A struct format without repeat counts: "@3P2iP" -> "PPPiiP"."""
    return "".join(c * int(n or 1)
                   for n, c in re.findall(r"(\d*)([A-Za-z])", fmt))


def test_argument_blocks_match_the_c_structs():
    """Every argument block _build packs has the fields of its struct in
    csrc/launch_args.cuh, in order (a pointer "P", an int "i", a long
    long "q", the stream last), and every entry point of the sources
    takes one block and is declared with the block it reads."""
    header = (_build.CSRC / "launch_args.cuh").read_text()
    structs = dict(re.findall(r"struct (\w+) \{(.*?)\};", header, re.S))
    assert set(structs) == set(_build.ARG_STRUCTS)
    for name, body in structs.items():
        fields = [f.strip() for f in body.split(";") if f.strip()]
        codes = "".join("P" if "*" in f else "q" if f.startswith("long long")
                        else "i" if f.startswith("int ") else "?"
                        for f in fields)
        fmt = _build.ARG_STRUCTS[name]
        assert fmt.startswith("@") and _expand(fmt[1:]) == codes, name
        assert fields[-1] == "void* stream", name
    entries = {}
    for src in _build._sources():
        text = src.read_text()
        for entry in re.findall(r"^int (pio_\w+)\(const void\* block\)",
                                text, re.M):
            entries[entry] = text
    assert set(entries) == set(_build.ENTRY_ARGS) - {"pio_noop"}
    for entry, text in entries.items():
        # the file that defines the entry point reads its block
        assert f"load_args<{_build.ENTRY_ARGS[entry]}>" in text, entry


def test_launches_from_many_threads_are_all_counted(monkeypatch):
    """A parallel evaluation sweep launches kernels from several threads:
    no count may be lost.  The library and the card are faked (an entry
    point that returns success), and the interpreter switches threads as
    often as it can."""
    monkeypatch.setattr(_build, "_lib", object())
    pack = struct.Struct(
        _build.ARG_STRUCTS[_build.ENTRY_ARGS["pio_noop"]]).pack
    monkeypatch.setitem(_build._ENTRY, "pio_noop", (lambda block: 0, pack))
    monkeypatch.setattr(_build, "_get_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    dev = torch.device("cuda", 0)
    workers, calls = 16, 5000

    def run(_):
        for _ in range(calls):
            _build.launch("pio_noop", "taa0_gather", dev, 0, 0, 0, 1, 1, 1)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for f in [pool.submit(run, w) for w in range(workers)]:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert _build.LAUNCHES["taa0_gather"] == workers * calls
