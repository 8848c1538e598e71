"""Sharded on-disk trajectory datasets.

Replacement for the ``scatspectra.TimeSeriesDataset`` surface used
by the reference (``/root/reference/shadowing/path_shadowing/
path_shadowing.py:84-87``, ``README.md:42``): a directory of ``.npy`` shards
(each ``(r_i, C, T)`` or ``(r_i, T)``), loaded lazily, keeping the first
``R`` trajectories.

Loading uses the native C shard reader (``shadowing_tpu.native``) when it has
been built — parallel mmap + readahead across shards — and falls back to
``numpy.load`` otherwise. Device placement (including sharding the R axis
over a mesh) is the caller's job; see ``shadowing_tpu.parallel``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _shard_files(dpath: Path) -> list[Path]:
    files = sorted(p for p in Path(dpath).iterdir() if p.suffix == ".npy")
    if not files:
        raise FileNotFoundError(f"no .npy shards under {dpath}")
    return files


class TimeSeriesDataset:
    """Lazy loader over a directory of ``.npy`` trajectory shards.

    :param dpath: directory containing ``.npy`` shards
    :param R: number of trajectories to keep (``None`` = all)
    """

    def __init__(self, dpath: Path | str, R: Optional[int] = None):
        self.dpath = Path(dpath)
        self.R = R
        self._files = _shard_files(self.dpath)

    def load(self) -> np.ndarray:
        """Materialise the first ``R`` trajectories as a ``(R, C, T)`` array."""
        arrays = _load_shards(self._files, self.R)
        out = np.concatenate(arrays, axis=0)
        if self.R is not None:
            if out.shape[0] < self.R:
                raise ValueError(
                    f"dataset under {self.dpath} holds {out.shape[0]} "
                    f"trajectories, fewer than requested R={self.R}"
                )
            out = out[: self.R]
        if out.ndim == 2:
            out = out[:, None, :]
        if out.ndim != 3:
            raise ValueError(f"shards must be (r, C, T) or (r, T), got {out.shape}")
        return np.ascontiguousarray(out, dtype=np.float32)


def _load_shards(files: Sequence[Path], R: Optional[int]) -> list[np.ndarray]:
    """Load shards until ``R`` trajectories are available (or all files)."""
    try:
        from shadowing_tpu.native import load_npy_batch  # C extension

        return load_npy_batch([str(f) for f in files], R)
    except ImportError:
        pass
    except (ValueError, OSError):
        # header-parsing or IO failure in the fast path: the numpy fallback
        # below re-reads everything through np.load
        pass

    arrays: list[np.ndarray] = []
    total = 0
    for f in files:
        a = np.load(f, mmap_mode="r")
        arrays.append(np.asarray(a))
        total += a.shape[0]
        if R is not None and total >= R:
            break
    return arrays


def batch_npy_files(
    input_directory: Path | str,
    batch_size: int,
    output_directory: Path | str,
) -> list[Path]:
    """Regroup many small per-trajectory ``.npy`` files into large shards.

    Mirrors ``/root/reference/scripts/batch_generations.py:12-49``: shards
    are named ``batch0001.npy`` … and hold ``batch_size`` source files each
    (trailing remainder kept).
    """
    input_directory = Path(input_directory)
    output_directory = Path(output_directory)
    output_directory.mkdir(parents=True, exist_ok=True)

    files = _shard_files(input_directory)
    written = []
    for i in range(0, len(files), batch_size):
        chunk = [np.load(f) for f in files[i : i + batch_size]]
        out = output_directory / f"batch{i // batch_size + 1:04d}.npy"
        np.save(out, np.concatenate(chunk))
        written.append(out)
    return written
