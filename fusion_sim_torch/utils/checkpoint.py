"""Checkpoint/resume (port of ``fusion_sim_tpu/utils/checkpoint.py``).

* ``save_npz``/``load_npz`` — dependency-free .npz of a flat
  ``{name: array}`` blob (the format of the models' ``get_state``), as the
  reference has them.
* ``save_torch``/``load_torch`` — ``torch.save``/``torch.load`` of a state
  dict (tensors, numbers, nested dicts), in place of the reference's
  ``save_orbax``/``load_orbax`` PyTree checkpoints.  Loading restores
  tensors only (``weights_only``), onto ``map_location`` if given.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_npz(path: str, blob: dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in blob.items()})


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_torch(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state, path)


def load_torch(path: str, map_location=None) -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)
