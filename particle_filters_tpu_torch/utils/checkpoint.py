"""Checkpoint and resume of filter state on ``torch.save`` (PyTorch port of
``particle_filters_tpu/utils/checkpoint.py``).

A state is any nest of tensors, numbers, dicts, lists, tuples and
dataclasses (``PFState``, the flows' states, DPF clouds, a resampler's
parameter pytree). It is written as plain containers of tensors, so
``torch.load`` reads it back with ``weights_only=True``; a ``template`` of
the same structure rebuilds the dataclasses and puts each tensor on the
template's device. The directory layout is the JAX package's:
``path/step_XXXXXXXX`` when a step is given.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

_FILE = "state.pt"


def _plain(state):
    """Dataclasses as dicts of their fields, tuples as lists, tensors
    detached on the CPU."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: _plain(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_plain(v) for v in state]
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    return state


def _rebuild(plain, template):
    """``plain`` in the structure, types and devices of ``template``."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{f.name: _rebuild(plain[f.name], getattr(template, f.name))
                                 for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(plain[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(p, t) for p, t in zip(plain, template))
    if isinstance(template, torch.Tensor):
        if plain.shape != template.shape or plain.dtype != template.dtype:
            raise ValueError(f"checkpoint leaf {tuple(plain.shape)} {plain.dtype} does not "
                             f"match the template's {tuple(template.shape)} {template.dtype}")
        return plain.to(template.device)
    return plain


def _step_dir(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    return path if step is None else os.path.join(path, f"step_{step:08d}")


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> str:
    """Save ``state`` under ``path`` (in ``step_XXXXXXXX`` when ``step`` is
    given), replacing what was there; returns the directory written."""
    path = _step_dir(path, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_plain(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def restore_checkpoint(path: str, template: Any = None, step: Optional[int] = None) -> Any:
    """Restore a state from ``path``: with ``template`` in its structure,
    dataclasses and devices (shapes and dtypes must match), else as plain
    dicts and lists of CPU tensors."""
    plain = torch.load(os.path.join(_step_dir(path, step), _FILE), weights_only=True)
    return plain if template is None else _rebuild(plain, template)


def latest_step(path: str) -> Optional[int]:
    """Largest ``step_XXXXXXXX`` subdirectory under ``path``, or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_")[1].isdigit()]
    return max(steps) if steps else None
