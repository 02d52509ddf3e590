"""Resource-pack discovery: locate named .stab resources on disk.

TPU-build counterpart of the reference's FilePaths resource machinery
(ref: SKIRT/core/FilePaths.cpp:143 findResources — recursive scan of the
resource directories; :267 resourceName — suffix + segment matching;
FilePaths.hpp:69). Resource packs are the reference's downloadable data
(SED family tables, broadband filter curves, grain optical properties);
this build reads the SAME .stab layout (utils/storedtable.py), so a user
can point SKIRT9_TPU_RESOURCES at an existing SKIRT9 resource tree and the
named items (BruzualCharlotSED, BroadBand("JOHNSON_V"), DraineSilicate
grain composition, ...) resolve drop-in.

Search roots, in order:
  1. every path in $SKIRT9_TPU_RESOURCES (os.pathsep separated)
  2. ~/SKIRT/resources9 (the reference's default download location)
  3. <repo>/resources
"""

from __future__ import annotations

import functools
import os


def resource_roots() -> list[str]:
    roots = []
    env = os.environ.get("SKIRT9_TPU_RESOURCES", "")
    roots += [p for p in env.split(os.pathsep) if p]
    roots.append(os.path.expanduser("~/SKIRT/resources9"))
    roots.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "resources"))
    return [r for r in roots if os.path.isdir(r)]


@functools.lru_cache(maxsize=8)
def _scan(roots_key: tuple) -> dict:
    """Recursive scan: resource filename -> full path (first hit wins,
    mirroring the reference's version-aware pack precedence loosely)."""
    found: dict[str, str] = {}
    for root in roots_key:
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in filenames:
                if fn not in found:
                    found[fn] = os.path.join(dirpath, fn)
    return found


def resource_index() -> dict:
    return _scan(tuple(resource_roots()))


def clear_cache() -> None:
    _scan.cache_clear()


def find_resource(filename: str) -> str:
    """Full path of a resource by exact filename.

    Raises FileNotFoundError with guidance when the resource (pack) is not
    installed (ref: FilePaths::resource error path)."""
    idx = resource_index()
    if filename in idx:
        return idx[filename]
    raise FileNotFoundError(
        f"resource '{filename}' not found; install the SKIRT9 resource "
        f"pack containing it and point SKIRT9_TPU_RESOURCES at the "
        f"directory (searched: {resource_roots() or 'no roots exist'})")


def has_resource(filename: str) -> bool:
    return filename in resource_index()


def resource_name(suffix: str, segments: list[str]) -> str:
    """Find the unique resource filename ending in `suffix` whose name
    contains every segment (ref: FilePaths::resourceName matching for
    BroadBand: segments derived from the band name, BroadBand.cpp:27-33)."""
    segs = [s.upper().strip("_") for s in segments]
    hits = []
    for fn in resource_index():
        if not fn.endswith(suffix):
            continue
        up = fn.upper()
        parts = up[: -len(suffix)].split("_")
        if all(s in parts for s in segs):
            hits.append(fn)
    if not hits:
        raise FileNotFoundError(
            f"no resource matching *{suffix} with segments {segs} "
            f"(searched: {resource_roots() or 'no roots exist'})")
    if len(hits) > 1:
        raise ValueError(f"multiple resources match {segs}: {sorted(hits)}")
    return hits[0]
