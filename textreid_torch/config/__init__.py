"""The config tree of the port: its own copy of ``textreid_tpu/config``
(same keys and defaults, ``TPU.*`` included, so every YAML under
``configs/`` loads unchanged in both packages).  No tensor library is
imported here."""

from .catalog import DatasetCatalog
from .defaults import get_default_cfg
from .flagship import flagship_batch, flagship_cfg
from .node import ConfigNode

__all__ = ["ConfigNode", "DatasetCatalog", "flagship_batch",
           "flagship_cfg", "get_default_cfg"]
