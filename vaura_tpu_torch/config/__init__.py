"""Config assembly and ``{target, params}`` instantiation (counterpart of
``vaura_tpu/config``)."""

from vaura_tpu_torch.config.loader import (
    MANDATORY,
    ConfigError,
    MissingMandatoryValue,
    assemble_config,
    check_mandatory,
    deep_merge,
    get_by_dotted,
    load_config,
    load_yaml,
    parse_dotlist,
    resolve_config,
    set_by_dotted,
)
from vaura_tpu_torch.config import registry as _registry
from vaura_tpu_torch.config.registry import get_obj_from_target, register, register_alias


def instantiate_from_config(config, **extra_kwargs):
    _registry.ensure_aliases()
    return _registry.instantiate_from_config(config, **extra_kwargs)


__all__ = [
    "MANDATORY",
    "ConfigError",
    "MissingMandatoryValue",
    "assemble_config",
    "check_mandatory",
    "deep_merge",
    "get_by_dotted",
    "load_config",
    "load_yaml",
    "parse_dotlist",
    "resolve_config",
    "set_by_dotted",
    "instantiate_from_config",
    "get_obj_from_target",
    "register",
    "register_alias",
]
