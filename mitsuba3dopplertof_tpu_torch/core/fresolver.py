"""File resolver with search paths (reference src/core/fresolver.cpp +
the thread-local resolver on Thread). `mi.load_file` scopes the scene
file's directory so relative mesh/texture/volume/data filenames resolve
against the scene location, matching the reference's behavior; users can
append extra search paths with `mi.file_resolver().append(path)`."""

from __future__ import annotations

import contextlib
import os
from typing import List


class FileResolver:
    def __init__(self):
        self.paths: List[str] = [os.getcwd()]

    def append(self, path: str) -> None:
        if path and path not in self.paths:
            self.paths.append(path)

    def prepend(self, path: str) -> None:
        if path:
            self.paths.insert(0, path)

    def resolve(self, name: str) -> str:
        """First existing candidate among the search paths; absolute paths
        and paths that exist as-given pass through (fresolver.cpp
        resolve())."""
        if os.path.isabs(name) or os.path.exists(name):
            return name
        for p in self.paths:
            cand = os.path.join(p, name)
            if os.path.exists(cand):
                return cand
        return name       # let the consumer raise its own not-found error

    @contextlib.contextmanager
    def scoped(self, path: str):
        self.paths.insert(0, path)
        try:
            yield self
        finally:
            try:
                self.paths.remove(path)
            except ValueError:
                pass


_resolver = FileResolver()


def file_resolver() -> FileResolver:
    return _resolver


def resolve_filename(name: str) -> str:
    return _resolver.resolve(name)


__all__ = ["FileResolver", "file_resolver", "resolve_filename"]
