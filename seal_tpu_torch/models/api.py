"""Model-family dispatch (counterpart of ``seal_tpu/models/api.py``): BART
and T5 share one functional interface (``init_params`` / ``encode`` /
``decode_full`` / ``decode_step`` / caches / ``reorder_cache``), selected by
the config's type or its ``family``, so the constrained decoder and the
scorers are family-agnostic.  ``cast_params`` lives in ``models/convert.py``
and is re-exported here, as the JAX module defines it."""

from __future__ import annotations

from seal_tpu_torch.models import bart as _bart
from seal_tpu_torch.models import t5 as _t5
from seal_tpu_torch.models.config import BartConfig
from seal_tpu_torch.models.convert import cast_params  # noqa: F401 (re-exported)
from seal_tpu_torch.models.t5 import T5Config


def module_for(cfg):
    if isinstance(cfg, T5Config) or getattr(cfg, "family", "bart") == "t5":
        return _t5
    if isinstance(cfg, BartConfig):
        return _bart
    raise TypeError(f"unknown model config type: {type(cfg)!r}")
