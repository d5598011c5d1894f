"""State carried from the JAX package into the port.

The system has no weights: its state is the dense stereo configuration and
the rig geometry.  `config_from_jax` turns a wass_tpu DenseStereoConfig
into the port's (same fields, from `dataclasses.asdict`, no jax import);
`geom_pack_from_numpy` turns the JAX `build_geom_pack` dict, fetched as
numpy arrays, into the port's tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wass_tpu_torch.stereo.dense import DenseStereoConfig


def config_from_jax(cfg) -> DenseStereoConfig:
    values = dataclasses.asdict(cfg)
    fields = {f.name for f in dataclasses.fields(DenseStereoConfig)}
    missing = fields - set(values)
    if missing:
        raise ValueError(f"config lacks fields {sorted(missing)}")
    kw = {k: values[k] for k in fields}
    kw["census_win"] = tuple(kw["census_win"])
    return DenseStereoConfig(**kw)


def geom_pack_from_numpy(pack: dict, device="cpu") -> dict:
    out = {}
    for key, value in pack.items():
        a = np.asarray(value)
        if key == "base_is_cam0":
            out[key] = bool(a)
        elif a.dtype == np.bool_:
            out[key] = torch.as_tensor(a.copy(), device=device)
        else:
            out[key] = torch.as_tensor(a.astype(np.float32), device=device)
    return out
