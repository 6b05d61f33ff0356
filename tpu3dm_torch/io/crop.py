"""Headless point-cloud cropping (a copy of tpu3dm/io/crop.py).

The reference crops interactively (a box dragged in a viewer); here the
region is an axis-aligned bounding box or a fraction along one axis.  As in
the reference, an empty selection writes the original cloud.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpu3dm_torch.io.ply import read_ply, write_ply
from tpu3dm_torch.utils.logging import setup_logging

logger = setup_logging(__name__)


def crop_points(
    points: np.ndarray,
    *,
    bounds: list[float] | None = None,
    fraction: float | None = None,
    axis: int = 0,
) -> np.ndarray:
    """Crop by bounding box [xmin, xmax, ymin, ymax, zmin, zmax] or by the
    lower ``fraction`` of the extent along ``axis``."""
    if bounds is not None:
        b = np.asarray(bounds, np.float64).reshape(3, 2)
        keep = np.all((points >= b[:, 0]) & (points <= b[:, 1]), axis=1)
    elif fraction is not None:
        lo = points[:, axis].min()
        hi = points[:, axis].max()
        keep = points[:, axis] <= lo + fraction * (hi - lo)
    else:
        raise ValueError("crop needs bounds or fraction")
    return points[keep]


def crop_file(
    source: str | Path,
    dest: str | Path,
    *,
    bounds: list[float] | None = None,
    fraction: float | None = None,
    axis: int = 0,
) -> int:
    """Crop a PLY file into ``dest``; returns the points written (the whole
    cloud when the selection is empty)."""
    data = read_ply(source)
    cropped = crop_points(data["points"], bounds=bounds, fraction=fraction, axis=axis)
    if cropped.shape[0] == 0:
        logger.warning("crop selected 0 points; writing the original cloud")
        cropped = data["points"]
    write_ply(dest, cropped)
    return int(cropped.shape[0])
