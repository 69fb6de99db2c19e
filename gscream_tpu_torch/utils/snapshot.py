"""Run reproducibility: snapshot the source into the run directory
(counterpart of ``gscream_tpu/utils/snapshot.py``).

The reference copies its code tree next to each run's outputs
(``saveRuntimeCode``, train.py:1053-1064) so that results stay
attributable to one code state.  Here the snapshot is one zip of the
repository's ``.py`` and ``.md`` files and the port's CUDA sources
(``.cu``, ``.cuh``): the kernels a run launched are built from those, so
without them the snapshot would not pin the code that ran.  It also
holds ``GIT_HEAD``, the commit when git can tell it.  Build outputs
(``gscream_tpu_torch/build/``), the git-ignored run outputs at the root
(``*_out/``) and unpacked trees of other commits (``*_tree/``) are left
out.
"""
from __future__ import annotations

import os
import subprocess
import zipfile

_SKIP_NAMES = {".git", "data", "output", "__pycache__", "log_training",
               ".pytest_cache", ".hypothesis"}
_SKIP_PATHS = {os.path.join("gscream_tpu_torch", "build")}
_SKIP_ROOT_SUFFIXES = ("_out", "_tree")
_SUFFIXES = (".py", ".md", ".cu", ".cuh")


def save_runtime_code(out_dir: str) -> str:
    """Zip the sources under the repository into
    ``out_dir/code_snapshot.zip``; returns the zip's path."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(out_dir, exist_ok=True)
    dst = os.path.join(out_dir, "code_snapshot.zip")
    out_abs = os.path.abspath(out_dir)
    with zipfile.ZipFile(dst, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(repo):
            rel_root = os.path.relpath(root, repo)
            dirs[:] = sorted(
                d for d in dirs if d not in _SKIP_NAMES
                and os.path.normpath(os.path.join(rel_root, d))
                not in _SKIP_PATHS
                and not (rel_root == "." and d.endswith(_SKIP_ROOT_SUFFIXES))
                and os.path.join(root, d) != out_abs)
            for f in sorted(files):
                if f.endswith(_SUFFIXES):
                    p = os.path.join(root, f)
                    z.write(p, os.path.relpath(p, repo))
        try:
            head = subprocess.run(
                ["git", "-C", repo, "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=10).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            head = ""
        z.writestr("GIT_HEAD", head + "\n")
    return dst
