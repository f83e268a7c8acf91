"""Carry chain state and bookkeeping between the JAX package and the port.

The JAX engine's state pytree and bookkeeping, taken to host numpy arrays
(``np.asarray`` of each leaf), become the port's tensors and back, so
both engines can be evaluated at identical states.  Integer leaves become
int64 (torch indexing) and float leaves float32.  JAX PRNG keys have no
torch counterpart: the port seeds its generators from the key words.

Every leaf is carried by name: unlinked trees' [C, n_trees, n_nodes]
tree arrays, the doublet frequencies ``pi16``, M3's ``m3omega`` and
``m3probs``, M10's ``m10beta``, ``m10gamma`` and ``m10catprobs``, a
restriction division's ``pi2``, the directional root frequencies
``rootpi2`` with the mixed model's indicator ``dirpi_on`` (int32 there,
int64 here), the covarion switch rates ``covswitch`` [C, G, 2], the
adgamma correlation ``ratecorr``, the kmixture simplex ``mixtrates``,
symdirihyperpr's ``symbeta`` and multistate frequencies ``sympi<k>`` and
the Brownian variance rate ``brownscale`` cross as they are, and so do a
BEST state's gene trees ``left``/``right``/``parent`` (int64 here) and
``age`` [C, G, n_nodes], its species tree ``s_left``/``s_right``/
``s_parent``/``s_age`` [C, 2S-1] and its ``popsize``.  A covarion
or symdirihyperpr division has no eigensystem cache in the JAX package
(it rebuilds its eigensystems in every likelihood); the port keeps one
(a binary symdiri character's category frequencies ``eigP{i}`` beside
it), built from the carried parameters by ``refresh_eigs``.  A partitioned state keeps each
division's eigensystem cache (``eigL{i}``, ``eigU{i}``, ``eigV{i}``),
standard (Mk) divisions' included: the port's engine computes those once
when it is built and keeps none in its own states, but uses a carried one
when a state has it (``Engine._division_eig_cached``).
"""
from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(states: dict, device) -> dict:
    """JAX chain states (numpy leaves, leading chain axis) -> tensors."""
    out = {}
    for k, v in states.items():
        a = np.asarray(v)
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) \
            else torch.bool if a.dtype == np.bool_ else torch.float32
        out[k] = torch.tensor(a, dtype=dtype, device=device)
    return out


def state_to_numpy(states: dict) -> dict:
    """Port chain states -> numpy, with the JAX package's dtypes (int32
    indices, float32 values)."""
    out = {}
    for k, v in states.items():
        a = v.detach().cpu().numpy()
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int32)
        out[k] = a
    return out


def _seed_of(key) -> int:
    words = np.asarray(key, np.uint64).reshape(-1)
    return int(words[0]) << 32 | int(words[-1])


def bookkeeping_from_numpy(bk: dict, device) -> dict:
    """JAX bookkeeping (numpy leaves) -> the port's: generators seeded
    from the PRNG keys, counters as device tensors, and the generation,
    autotune batch and power as Python numbers."""
    dev = torch.device(device)
    seed = _seed_of(bk["key"])
    out = {
        "rng": torch.Generator(device=dev).manual_seed(seed),
        "rng_host": torch.Generator().manual_seed(seed),
        "rng_swap": torch.Generator(device=dev).manual_seed(
            _seed_of(bk["swap_key"])),
        "temp_id": torch.tensor(np.asarray(bk["temp_id"]),
                                dtype=torch.int64, device=dev),
        "tuning": torch.tensor(np.asarray(bk["tuning"]),
                               dtype=torch.float32, device=dev),
        "batch": int(np.asarray(bk["batch"])),
        "gen": int(np.asarray(bk["gen"])),
        "power": float(np.asarray(bk.get("power", 1.0))),
    }
    for k in ("tries", "accepts", "tries_total", "accepts_total",
              "swap_tries", "swap_accepts"):
        out[k] = torch.tensor(np.asarray(bk[k]), dtype=torch.int32,
                              device=dev)
    return out
