from .config import ConfigNode, get_default_config, update_config, load_config

__all__ = ["ConfigNode", "get_default_config", "update_config", "load_config"]
