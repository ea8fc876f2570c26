"""The one traffic generator: it reads a mix's parameters
(`benchmark/traffic/<mix>.json`) and, from the run's seed, yields the calls
the measured window makes.  Every mix is a closed loop, one client, whose
``client`` names `benchmark/clients/<client>.py`:

- ``"ingest"``: each call encodes ``corpus_blocks`` contiguous blocks,
  wrapping, of a pool of ``pool_blocks`` made at set-up;
- ``"restore"``: each call decodes ``corpus_blocks`` contiguous blocks of
  a container of ``container_blocks`` written at set-up.

The start of each call is uniform over the starts the mix allows, so every
seed does the same work on other blocks.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .inputs import derived_seed

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")


def load_mix(name: str) -> dict:
    with open(os.path.join(TRAFFIC_DIR, f"{name}.json")) as f:
        return json.load(f)


def starts(n_starts: int, seed: int):
    """Endless starts of the calls, uniform in ``[0, n_starts)``."""
    rng = np.random.default_rng(derived_seed(seed, 10))
    while True:
        yield int(rng.integers(0, n_starts))
