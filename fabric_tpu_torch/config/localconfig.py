"""Node-config loading with an environment-variable override tier.

Reference parity: Fabric's common/viperutil/config_util.go plus the
CORE_* / ORDERER_* env tiers its binaries install at startup
(cmd/peer/main.go:31-34, orderer/common/localconfig).
Precedence, low to high:

  1. the node's JSON config file,
  2. ``FABRIC_TPU_<ROLE>_...`` environment variables.

Naming: the env suffix is the upper-cased config key; ``__`` (double
underscore) descends into nested objects — a single ``_`` stays part of
the key, so keys like ``ops_port`` are unambiguous (viper's single-'_'
nesting cannot express them):

  FABRIC_TPU_PEER_PORT=9443            ->  cfg["port"] = 9443
  FABRIC_TPU_PEER_OPS_PORT=9444        ->  cfg["ops_port"] = 9444
  FABRIC_TPU_ORDERER_RAFT__TICK_MS=50  ->  cfg["raft"]["tick_ms"] = 50

Values parse as JSON when possible (numbers, booleans, lists, objects)
and fall back to the raw string — ``FABRIC_TPU_PEER_HOST=0.0.0.0``
needs no quoting.

Counterpart of `fabric_tpu/config/localconfig.py`, the same code on the
port's imports.  The prefix stays ``FABRIC_TPU_<ROLE>_``, the one the
reference reads, so one deployment's environment drives a node of either
package.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

logger = logging.getLogger("fabric_tpu_torch.config.localconfig")


def apply_env_overrides(cfg: dict, role: str,
                        environ: Optional[dict] = None) -> dict:
    """Layer FABRIC_TPU_<ROLE>_* overrides onto cfg (mutated + returned)."""
    env = os.environ if environ is None else environ
    prefix = f"FABRIC_TPU_{role.upper()}_"
    for name in sorted(env):
        if not name.startswith(prefix) or name == prefix:
            continue
        path = name[len(prefix):].lower().split("__")
        raw = env[name]
        try:
            value = json.loads(raw)
        except ValueError:
            value = raw
        node = cfg
        ok = True
        for part in path[:-1]:
            nxt = node.get(part)
            if nxt is None:
                nxt = node[part] = {}
            elif not isinstance(nxt, dict):
                logger.warning("env override %s: %r is not an object; "
                               "ignored", name, part)
                ok = False
                break
            node = nxt
        if ok:
            node[path[-1]] = value
            logger.info("config override from env: %s", name)
    return cfg


def load_node_config(path: str, role: str,
                     environ: Optional[dict] = None) -> dict:
    """Read a node JSON config and apply the env override tier."""
    with open(path) as f:
        cfg = json.load(f)
    return apply_env_overrides(cfg, role, environ=environ)
