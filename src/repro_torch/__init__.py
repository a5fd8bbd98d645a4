"""PyTorch/CUDA port of the compressed-weight serving runtime in ``repro``.

Modules mirror ``repro``'s layout so each has an obvious counterpart.
The port imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro`` (it keeps its own copy of the numpy at-rest format in
``repro_torch.core``).  Kernels written by hand for Hopper live under
``repro_torch/csrc`` and are built with ``nvcc`` at first use
(``repro_torch.kernels._build``); each has a plain PyTorch version beside
it that runs on CPU tensors.
"""

import torch


def resolve_device(device) -> torch.device:
    """An entry point's ``device`` argument -> ``torch.device``.

    ``"cuda"`` (the default of every entry point) needs a card: with none
    this raises rather than carrying on on the CPU.  Only an explicit
    ``"cpu"`` runs the plain versions; ``"meta"`` gives shapes and dtypes
    without storage (``launch.steps.train_state_specs``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
