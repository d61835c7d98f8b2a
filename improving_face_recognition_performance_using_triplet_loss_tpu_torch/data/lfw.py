"""LFW pairs-file protocol input (reference test protocol, README.md:26;
pair parsing conventions of the facenet evaluator). A copy of the JAX
package's ``data/lfw.py``."""

from __future__ import annotations

import os

import numpy as np


def read_pairs(pairs_path: str) -> list[list[str]]:
    """Parse pairs.txt: skips the header line; each line is either
    ``name n1 n2`` (same identity) or ``name1 n1 name2 n2`` (different)."""
    pairs = []
    with open(pairs_path) as f:
        for line in f.readlines()[1:]:
            parts = line.strip().split()
            if parts:
                pairs.append(parts)
    return pairs


def get_paths(lfw_dir: str, pairs: list[list[str]], file_ext: str = "jpg"):
    """Resolve pairs to (path_list flattened [2*n], issame [n])."""
    paths = []
    issame = []
    skipped = 0
    for pair in pairs:
        if len(pair) == 3:
            p0 = os.path.join(lfw_dir, pair[0],
                              f"{pair[0]}_{int(pair[1]):04d}.{file_ext}")
            p1 = os.path.join(lfw_dir, pair[0],
                              f"{pair[0]}_{int(pair[2]):04d}.{file_ext}")
            same = True
        elif len(pair) == 4:
            p0 = os.path.join(lfw_dir, pair[0],
                              f"{pair[0]}_{int(pair[1]):04d}.{file_ext}")
            p1 = os.path.join(lfw_dir, pair[2],
                              f"{pair[2]}_{int(pair[3]):04d}.{file_ext}")
            same = False
        else:
            continue
        if os.path.exists(p0) and os.path.exists(p1):
            paths += [p0, p1]
            issame.append(same)
        else:
            skipped += 1
    if skipped:
        print(f"Skipped {skipped} image pairs (missing files)")
    return paths, np.asarray(issame, bool)
