"""Save and load any registered fit state (PLSFit, OPLSFit, KPLSFit,
Residual, MonitorModel, CDFit, MBPLSFit, NPLSFit, ...).

Counterpart of `pls_tpu/utils/checkpoint.py`, in its `.npz` layout, so
that a file either package writes, the other loads:

  - each tensor field is an entry `leaf:<field>`, a nested state's
    `leaf:<field>/<subfield>` (one nesting level: `OPLSFit.pls`,
    `MBPLSFit.pls` are PLSFits);
  - `meta` is a JSON string {"type": <class name>, "aux": {...}} with
    every other field (a `METHOD` as {"__enum__": value}) and a nested
    state's under "/<field>".

The JAX package walks its pytrees with `jax.tree_util`; here the
dataclass fields are walked directly: a tensor is a leaf, a dataclass a
nested state, anything else aux.  No pickle: `allow_pickle=False`.

`save_fit_orbax`/`load_fit_orbax` keep their names but not orbax's
format: a directory holding `meta.json` (the same type and aux) beside
`arrays.pt`, a `torch.save` of the leaves, loaded with
`weights_only=True`.  Such a directory does not load in the JAX package,
nor an orbax directory here.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from pls_tpu_torch.types import METHOD, PLSFit, Residual

# registry of persistable state dataclasses (name -> class)
_TYPES: dict[str, type] = {}


def register_checkpointable(cls: type) -> type:
    """Register a frozen dataclass of tensors for save_fit/load_fit (usable
    as a decorator on user-defined fit states)."""
    _TYPES[cls.__name__] = cls
    return cls


register_checkpointable(PLSFit)
register_checkpointable(Residual)


def _ensure_ext_types():
    # lazy: the model modules import this one
    from pls_tpu_torch.models.kpls import KPLSFit
    from pls_tpu_torch.models.opls import OPLSFit

    register_checkpointable(KPLSFit)
    register_checkpointable(OPLSFit)


def _encode_aux(v):
    return {"__enum__": v.value} if isinstance(v, METHOD) else v


def _decode_aux(v):
    if isinstance(v, dict) and "__enum__" in v:
        return METHOD(v["__enum__"])
    return tuple(v) if isinstance(v, list) else v


def _split(obj, prefix: str = ""):
    """({path: tensor} leaves, aux dict) of a state dataclass."""
    leaves, aux = {}, {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            leaves[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            sub_leaves, sub_aux = _split(v, prefix + f.name + "/")
            leaves.update(sub_leaves)
            if sub_aux:
                aux["/" + f.name] = sub_aux
        else:
            aux[f.name] = _encode_aux(v)
    return leaves, aux


def _checked_name(fit) -> str:
    _ensure_ext_types()
    name = type(fit).__name__
    if name not in _TYPES:
        raise TypeError(f"{name} is not checkpointable; register_checkpointable() it")
    return name


def save_fit(fit, path: str) -> None:
    """Write a registered fit state to `path` (.npz, no pickle)."""
    name = _checked_name(fit)
    leaves, aux = _split(fit)
    arrays = {f"leaf:{k}": v.detach().cpu().numpy() for k, v in leaves.items()}
    np.savez(path, **arrays, meta=json.dumps({"type": name, "aux": aux}))


def _rebuild(meta: dict, leaves: dict):
    """The state object from {path: tensor} leaves and meta's aux."""
    cls = _TYPES.get(meta["type"])
    if cls is None:
        raise TypeError(f"unknown checkpoint type {meta['type']!r}")
    kwargs: dict = {}
    for field_path, val in leaves.items():
        top, _, rest = field_path.partition("/")
        if rest:
            kwargs.setdefault(top, {})[rest] = val
        else:
            kwargs[top] = val
    aux = dict(meta["aux"])
    for k, v in list(kwargs.items()):
        if isinstance(v, dict):
            # one nesting level serves every shipped type: a nested PLSFit
            sub_aux = {sk: _decode_aux(sv) for sk, sv in aux.pop("/" + k, {}).items()}
            kwargs[k] = PLSFit(**v, **sub_aux)
    for k, v in aux.items():
        if not k.startswith("/"):  # nested aux of an absent field: ignored
            kwargs[k] = _decode_aux(v)
    return cls(**kwargs)


def load_fit(path: str, *, device: torch.device | str | None = None):
    """The fit state `save_fit` (of either package) wrote to `path`, its
    tensors on `device` (None: the card; RuntimeError without one)."""
    from pls_tpu_torch.config import resolve_device

    _ensure_ext_types()
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        leaves = {k[len("leaf:"):]: torch.from_numpy(z[k]).to(device)
                  for k in z.files if k.startswith("leaf:")}
    return _rebuild(meta, leaves)


def save_fit_orbax(fit, path: str) -> None:
    """Write a registered fit state to the directory `path`: `meta.json`
    and `arrays.pt` (`torch.save` of the leaves, on the CPU).  An existing
    checkpoint there is overwritten."""
    name = _checked_name(fit)
    leaves, aux = _split(fit)
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in leaves.items()}, os.path.join(path, "arrays.pt"))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump({"type": name, "aux": aux}, fh)


def load_fit_orbax(path: str, *, device: torch.device | str | None = None):
    """The fit state `save_fit_orbax` wrote to the directory `path`, on
    `device` (None: the card)."""
    from pls_tpu_torch.config import resolve_device

    _ensure_ext_types()
    device = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    arrays = torch.load(os.path.join(path, "arrays.pt"), map_location=device, weights_only=True)
    return _rebuild(meta, arrays)
