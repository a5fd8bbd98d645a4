"""ReActNet-A (the paper's own model) — see repro_torch.models.reactnet."""

from repro_torch.models.reactnet import CONFIG  # noqa: F401
