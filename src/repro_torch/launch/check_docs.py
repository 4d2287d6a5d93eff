"""Docs link check: every repo path referenced from ``docs/*.md`` must
exist (port of ``scripts/check_docs.py``, the same paths and pattern).

Scans the markdown under ``docs/`` for references that look like repo
paths (``src/...``, ``scripts/...``, ``tests/...``, ``benchmarks/...``,
``docs/...`` - bare or inside backticks/links) and returns nonzero,
listing any that no longer point at a real file or directory.
``launch/ci_smoke.py`` runs it last.

    PYTHONPATH=src python -m repro_torch.launch.check_docs
"""
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DOCS = os.path.join(ROOT, "docs")

# repo-relative paths: a known top-level dir, then /-separated
# identifier segments, optionally ending in an extension
_PATH = re.compile(
    r"\b((?:src|scripts|tests|benchmarks|docs)/[\w./-]*[\w])")


def referenced_paths(text):
    for m in _PATH.finditer(text):
        yield m.group(1).rstrip(".")


def main(argv=None) -> int:
    if not os.path.isdir(DOCS):
        print("check_docs: no docs/ directory", file=sys.stderr)
        return 1
    missing = []
    checked = 0
    for name in sorted(os.listdir(DOCS)):
        if not name.endswith(".md"):
            continue
        with open(os.path.join(DOCS, name)) as fh:
            text = fh.read()
        for path in referenced_paths(text):
            checked += 1
            if not os.path.exists(os.path.join(ROOT, path)):
                missing.append((name, path))
    for doc, path in missing:
        print(f"check_docs: docs/{doc} references missing {path}",
              file=sys.stderr)
    if missing:
        return 1
    print(f"check_docs: {checked} path references OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
