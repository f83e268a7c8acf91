"""mrbayes_tpu_torch — Bayesian phylogenetic inference on PyTorch and CUDA.

The PyTorch port of ``mrbayes_tpu``: the same module layout and names, with
an explicit chain axis where the JAX package used ``vmap`` and a
hand-written CUDA kernel (``ops/pruning_cuda.py`` + ``csrc/pruning.cu``) in
place of the Pallas pruning kernel.  The package imports ``torch`` and
never ``jax``; the numpy-only modules it needs (``nexus/``, ``data.py``,
``trees.py``, ``mcmc/settings.py``) are its own copies.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch device an entry point runs on: ``None`` means CUDA, and a
    CUDA request without a CUDA device raises (no silent CPU fallback)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
