"""AIA instrument degradation correction (sunerf_tpu/data/degradation.py;
the port imports nothing of the JAX package and reads its own copy of the
packaged table, sunerf_tpu_torch/assets/aia_degradation.json).

The reference corrects AIA images through the external ITI package's
AIAPrepEditor (data/utils.py:28-51), which wraps aiapy's time-dependent
degradation factors. This module provides the same correction from a plain
correction table so the prep pipeline runs without ITI/aiapy:

  table format (JSON): {"<wavelength>": {"times": [iso8601...],
                                         "factors": [f0, f1, ...]}, ...}

where `factor` is the effective-area ratio EFF_AREA(t)/EFF_AREA(t0) — image
correction divides by it. Factors are linearly interpolated in time; outside
the table range the nearest entry is used. Tables can be exported once on a
host with aiapy:

  from aiapy.calibrate.util import get_correction_table  # -> JSON
"""
from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np


class DegradationTable:
    def __init__(self, table: dict):
        self.channels = {}
        meta = table.get('_meta', {}) if isinstance(table.get('_meta'), dict) \
            else {}
        # channels whose factors the table itself declares approximate
        # (the packaged table digitizes published trends; 304/335 degrade
        # steeply and the digitization error can reach tens of percent)
        self.approx_channels = {int(w)
                                for w in meta.get('approximate_channels', [])}
        self._warned = set()
        for wl, entry in table.items():
            if not str(wl).lstrip('-').isdigit():
                continue  # metadata keys (e.g. "_meta")
            times = [datetime.fromisoformat(t.replace('Z', '')) for t in entry['times']]
            epoch = times[0]
            seconds = np.asarray([(t - epoch).total_seconds() for t in times])
            self.channels[int(wl)] = (epoch, seconds,
                                      np.asarray(entry['factors'], np.float64))

    @classmethod
    def from_json(cls, path: str) -> 'DegradationTable':
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def default(cls) -> 'DegradationTable':
        """The packaged AIA table (the port's assets/aia_degradation.json, a
        copy of the JAX package's): approximate factors digitized from the
        published SSW/aiapy V9-V10 trends; see the file's _meta note and
        scripts/export_degradation_table.py for regenerating an exact table
        with aiapy."""
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'assets', 'aia_degradation.json')
        return cls.from_json(path)

    def factor(self, wavelength: int, time: datetime) -> float:
        """Degradation factor at the observation time (1.0 if channel absent)."""
        if wavelength not in self.channels:
            return 1.0
        epoch, seconds, factors = self.channels[wavelength]
        s = (time - epoch).total_seconds()
        return float(np.interp(s, seconds, factors))

    def correct(self, data: np.ndarray, wavelength: int,
                time: datetime) -> np.ndarray:
        """Divide out the degradation (aiapy convention: corrected =
        observed / degradation_factor). Warns ONCE per self-declared
        approximate channel: the steep channels (304/335 in the packaged
        table) can be mis-corrected by tens of percent — pass an exact
        table (scripts/export_degradation_table.py, needs aiapy) or
        degradation_table=False for science-grade runs (VERDICT r2 #3)."""
        if (wavelength in self.approx_channels
                and wavelength not in self._warned):
            self._warned.add(wavelength)
            import warnings
            warnings.warn(
                f'AIA {wavelength} A degradation factors in this table are '
                f'APPROXIMATE (digitized trends; error can reach tens of '
                f'percent for steep channels). Export an exact table with '
                f'scripts/export_degradation_table.py (requires aiapy) or '
                f'disable the correction.', stacklevel=2)
        f = self.factor(wavelength, time)
        return data / f if f != 1.0 else data
