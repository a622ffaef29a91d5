"""The port's configuration: the JAX package's config tree, shared as it is
(``textreid_tpu.config`` imports no JAX).  The YAMLs under ``configs/``
serve both packages unchanged."""

from textreid_tpu.config import ConfigNode, flagship_cfg, get_default_cfg

__all__ = ["ConfigNode", "flagship_cfg", "get_default_cfg"]
