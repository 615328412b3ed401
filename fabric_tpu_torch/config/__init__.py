"""Channel-config plane: typed config, live bundles, config transactions.

Re-design of Fabric's common/{channelconfig,configtx,capabilities}:
config-as-consensus-state with atomic bundle swap on committed config
blocks.

Counterpart of `fabric_tpu/config/`, whole: `channelconfig.py`,
`configtx.py`, `localconfig.py` (the node's JSON config with its
environment-variable tier) and `lator.py` (configtxlator's JSON
translation).
"""

from .channelconfig import (
    Bundle,
    BundleSource,
    BatchConfig,
    CAP_KEY_LEVEL_ENDORSEMENT,
    CAP_V2_0,
    ChannelConfig,
    ConfigError,
    OrgConfig,
    default_policies,
)
from .configtx import (
    apply_config_block,
    build_config_envelope,
    parse_config_envelope,
    validate_config_update,
    validate_parsed_config_update,
    config_envelope_of,
)

__all__ = [
    "Bundle", "BundleSource", "BatchConfig", "ChannelConfig", "ConfigError",
    "OrgConfig", "default_policies", "CAP_V2_0", "CAP_KEY_LEVEL_ENDORSEMENT",
    "apply_config_block", "build_config_envelope", "parse_config_envelope",
    "validate_config_update", "validate_parsed_config_update", "config_envelope_of",
]
