"""Findings model shared by every checker in ``repro_torch.analysis``.

The analysis subsystem is deliberately dependency-free (stdlib only):
it must be runnable as a smoke gate on a box where torch/numpy are
broken, because its whole job is to catch the contract rot that breaks
them.  A checker consumes :class:`Source` objects (one parsed file)
and yields :class:`Finding`s; the CLI matches findings against an
explicit :class:`Baseline` and exits nonzero on anything unbaselined.

Annotation protocol
-------------------
Several checkers accept an in-source annotation that sanctions a
deliberate contract exception (``# benign-race: <contract>``,
``# layer-ok: <reason>``, ``# wall-clock: <reason>``,
``# crash-containment: <reason>``).  An annotation counts when it
appears on the flagged statement's first physical line or on the line
immediately above it, and it MUST carry a non-empty justification
after the colon — a bare tag is itself a finding.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Iterable, Iterator, List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location.

    The ``fingerprint`` hashes the checker, code, file and the
    *stripped source text* of the flagged line — not the line number —
    so a baseline entry survives unrelated edits above the finding but
    dies with the code it described.
    """

    checker: str     # e.g. "LockOrderChecker"
    code: str        # e.g. "LO001"
    path: str        # posix path from the package root, "repro_torch/..."
    line: int        # 1-indexed
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        key = "|".join((self.checker, self.code, self.path,
                        " ".join(self.snippet.split())))
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.code}] {self.message}"
                + (f"\n    {self.snippet.strip()}" if self.snippet else ""))


_ANNOTATION_RE = re.compile(r"#\s*(benign-race|layer-ok|wall-clock|"
                            r"crash-containment)\s*:\s*(.*\S)?")


class Source:
    """One parsed source file plus the comment context checkers need."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)

    @classmethod
    def load(cls, path: str, rel: str) -> "Source":
        with open(path, "r", encoding="utf-8") as fh:
            return cls(path, rel, fh.read())

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def annotation(self, lineno: int, tag: str) -> Optional[str]:
        """Justification text of a ``# <tag>: ...`` annotation covering
        ``lineno`` — on the statement's own line or anywhere in the
        contiguous comment block directly above it — else None.  A bare
        tag with no justification returns '' (caller flags it)."""
        candidates = [lineno]
        ln = lineno - 1
        while ln >= 1 and self.line(ln).lstrip().startswith("#"):
            candidates.append(ln)
            ln -= 1
        for ln in candidates:
            m = _ANNOTATION_RE.search(self.line(ln))
            if m and m.group(1) == tag:
                return m.group(2) or ""
        return None


class Checker:
    """Base class: subclasses set ``name`` and implement ``check``."""

    name = "Checker"

    def check(self, src: Source) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, code: str, src: Source, node_or_line,
                message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(self.name, code, src.rel, line, message,
                       src.line(line))


class Baseline:
    """Explicit allow-list of findings, one justified entry per
    fingerprint.  Missing file == empty baseline."""

    def __init__(self, entries: Optional[dict] = None):
        self.entries = dict(entries or {})

    @classmethod
    def load(cls, path: Optional[str]) -> "Baseline":
        if not path or not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        entries = {}
        for item in data.get("findings", []):
            entries[item["fingerprint"]] = item
        return cls(entries)

    def save(self, path: str, findings: Iterable[Finding]) -> None:
        data = {"findings": [
            {"fingerprint": f.fingerprint, "code": f.code, "path": f.path,
             "snippet": " ".join(f.snippet.split()),
             "justification": self.entries.get(f.fingerprint, {}).get(
                 "justification", "TODO: justify or fix")}
            for f in sorted(findings, key=lambda f: (f.path, f.line))]}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def matches(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    def split(self, findings: Iterable[Finding]):
        """(new, baselined, stale-fingerprints)."""
        findings = list(findings)
        new = [f for f in findings if not self.matches(f)]
        old = [f for f in findings if self.matches(f)]
        seen = {f.fingerprint for f in findings}
        stale = sorted(fp for fp in self.entries if fp not in seen)
        return new, old, stale


def iter_sources(paths: Iterable[str]) -> Iterator[Source]:
    """Yield a :class:`Source` for every ``.py`` file under ``paths``.

    The path recorded on findings is rooted at the ``repro_torch``
    package (``repro_torch/streams/arena.py``) so checker site tables and
    baseline fingerprints are stable no matter which prefix the CLI was
    given.
    """
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__",))
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
    seen = set()
    for path in files:
        ap = os.path.abspath(path)
        if ap in seen:
            continue
        seen.add(ap)
        yield Source.load(path, package_rel(path))


PACKAGE = "repro_torch"


def package_rel(path: str) -> str:
    """Path relative to the directory containing the ``repro_torch``
    package (falls back to the basename chain when no ``repro_torch``
    component)."""
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    if PACKAGE in parts:
        idx = len(parts) - 1 - parts[::-1].index(PACKAGE)
        return "/".join(parts[idx:])
    return "/".join(parts[-2:])


def dotted_name(node: ast.AST) -> Optional[str]:
    """'self.loop._lock' for a pure Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
