"""Chaos harness: a live in-process topology with kill/restart and
fault-plan drills.

`ChaosNet` provisions a dev network (provision.provision_network),
starts every node in-process, and keeps each node's JSON config so any
component can be **crash-stopped** (`kill`) and **restarted**
(`restart`) against its on-disk state — the orderer replays its raft
WAL, the peer re-runs ledger recovery (`BlockStore._recover`,
`KVLedger._recover`).  The kill is the crash-stop model: listeners
close immediately, in-flight work is abandoned, and the only surviving
state is what was already durable on disk.

Combined with `fabric_tpu_torch.comm.faults` this is the robustness test
rig: install a seeded `FaultPlan`, drive traffic, kill/restart nodes,
then assert the convergence invariants with `heights()` /
`commit_hashes()` / `wait_converged()` — every peer at the same height
with the same chained commit hash, which is exactly the state-machine-
replication promise the pipeline must keep under faults.

    net = ChaosNet(base_dir, n_orderers=3)
    net.start()
    plan = faults.install(FaultPlan(seed=7).rule(drop=0.05, dup=0.05))
    ...drive traffic...
    net.kill("orderer1"); net.restart("orderer1")
    faults.uninstall()
    assert net.wait_converged(timeout_s=30)

Counterpart of `fabric_tpu/testing/chaos.py`, whole, on the port's
imports: its nodes are the port's `OrdererNode` and `PeerNode`, on the
providers their configs name (`"bccsp": "SW"` for the host).
"""

from __future__ import annotations

import errno
import json
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("fabric_tpu_torch.testing.chaos")


class ChaosNet:
    """One in-process dev network with lifecycle control per node."""

    def __init__(self, base_dir: str, n_orderers: int = 3,
                 peer_orgs=("Org1", "Org2"), peers_per_org: int = 1,
                 channel_id: str = "ch", batch=None,
                 gateway_cfg: Optional[dict] = None,
                 peer_overrides: Optional[dict] = None,
                 orderer_overrides: Optional[dict] = None,
                 node_factory=None, spare_orderers: int = 0):
        from fabric_tpu_torch.node.provision import provision_network
        self.base_dir = str(base_dir)
        self.channel_id = channel_id
        self.paths = provision_network(
            self.base_dir, n_orderers=n_orderers,
            peer_orgs=list(peer_orgs), peers_per_org=peers_per_org,
            channel_id=channel_id, batch=batch,
            spare_orderers=spare_orderers)
        self.gateway_cfg = gateway_cfg or {
            "linger_s": 0.002, "max_batch": 8,
            "broadcast_deadline_s": 20.0}
        self.peer_overrides = dict(peer_overrides or {})
        self.orderer_overrides = dict(orderer_overrides or {})
        # optional hook: callable(name, kind, cfg) -> node | None.  A
        # non-None return replaces the stock node — how adversarial
        # actors (testing/adversary.py) join a drill topology.
        self.node_factory = node_factory
        # name -> (kind, cfg-path); insertion order = start order
        self._specs: Dict[str, Tuple[str, str]] = {}
        for p in self.paths["orderers"]:
            self._specs[self._name_of(p)] = ("orderer", p)
        for p in self.paths["peers"]:
            self._specs[self._name_of(p)] = ("peer", p)
        # spare orderers: provisioned (identity + cfg on disk) but NOT
        # auto-started — a membership drill starts one with restart()
        # after committing its add-consenter config entry
        self._spares: set = set()
        for p in self.paths.get("spare_orderers", []):
            name = self._name_of(p)
            self._specs[name] = ("orderer", p)
            self._spares.add(name)
        self.nodes: Dict[str, object] = {}      # name -> live node

    @staticmethod
    def _name_of(cfg_path: str) -> str:
        import os
        return os.path.splitext(os.path.basename(cfg_path))[0]

    # -- lifecycle -------------------------------------------------------

    def _build(self, name: str):
        kind, path = self._specs[name]
        with open(path) as f:
            cfg = json.load(f)
        if kind == "orderer":
            cfg.update(self.orderer_overrides)
        else:
            cfg["gateway"] = dict(self.gateway_cfg)
            cfg.update(self.peer_overrides)
        if self.node_factory is not None:
            node = self.node_factory(name, kind, cfg)
            if node is not None:
                return node
        if kind == "orderer":
            from fabric_tpu_torch.node.orderer import OrdererNode
            return OrdererNode(cfg, data_dir=cfg["data_dir"])
        from fabric_tpu_torch.node.peer import PeerNode
        return PeerNode(cfg, data_dir=cfg["data_dir"])

    def start(self, leader_timeout_s: float = 60.0) -> "ChaosNet":
        for name, (kind, _) in self._specs.items():
            if kind == "orderer" and name not in self._spares:
                self.nodes[name] = self._build(name).start()
        self.wait_for_leader(leader_timeout_s)
        for name, (kind, _) in self._specs.items():
            if kind == "peer":
                self.nodes[name] = self._build(name).start()
        return self

    def spare_names(self) -> List[str]:
        """Provisioned-but-unjoined orderers, in raft-id order."""
        return sorted(self._spares)

    def spare_cfg(self, name: str) -> dict:
        """The spare's node config (raft_id, port, cert_fp, ...) — the
        material an add-consenter proposal needs."""
        _, path = self._specs[name]
        with open(path) as f:
            return json.load(f)

    def kill(self, name: str) -> None:
        """Crash-stop one node: close its listeners and abandon it.
        On-disk state stays exactly as fsync left it."""
        node = self.nodes.pop(name, None)
        if node is None:
            raise KeyError(f"{name!r} is not running")
        logger.warning("chaos: killing %s", name)
        node.stop()

    def restart(self, name: str, wait_s: float = 30.0):
        """Bring a killed node back from its on-disk state (raft WAL
        replay / ledger recovery happen in the constructor)."""
        if name in self.nodes:
            raise KeyError(f"{name!r} is already running")
        logger.warning("chaos: restarting %s", name)
        # the fixed port can transiently be claimed by an outbound
        # ephemeral connection (chaos retries dial constantly) or a
        # not-yet-drained socket from the killed node — retry the bind
        deadline = time.time() + 15.0
        while True:
            try:
                node = self._build(name).start()
                break
            except OSError as exc:
                if exc.errno != errno.EADDRINUSE or time.time() > deadline:
                    raise
                time.sleep(0.25)
        self.nodes[name] = node
        kind, _ = self._specs[name]
        if kind == "orderer":
            self.wait_for_leader(wait_s)
        return node

    def drain(self, name: str, timeout_s: float = 10.0) -> dict:
        """Graceful drain of one running node (peer or orderer): stop
        admitting, flush in-flight work, checkpoint/fsync, release
        leadership — the opposite of kill()'s crash-stop."""
        node = self.nodes.get(name)
        if node is None:
            raise KeyError(f"{name!r} is not running")
        logger.warning("chaos: draining %s", name)
        return node.drain(timeout_s=timeout_s)

    def rolling_restart(self, names: Optional[List[str]] = None,
                        drain_timeout_s: float = 10.0,
                        settle_s: float = 60.0) -> Dict[str, dict]:
        """The rolling-upgrade primitive: drain -> kill -> restart each
        named node in turn (default: every running node, orderers
        first), waiting for peer convergence after each peer restart so
        at most one node is ever down.  Returns per-node drain reports
        (a failed drain is recorded, the roll continues — an upgrade
        must not wedge on one stuck node)."""
        if names is None:
            names = [n for n, (k, _) in self._specs.items()
                     if n in self.nodes]
        reports: Dict[str, dict] = {}
        for name in names:
            if name not in self.nodes:
                continue
            try:
                reports[name] = self.drain(name,
                                           timeout_s=drain_timeout_s)
            except Exception as exc:
                logger.exception("chaos: drain of %s failed", name)
                reports[name] = {"error": str(exc)}
            self.kill(name)
            self.restart(name)
            if self._specs[name][0] == "peer":
                self.wait_converged(timeout_s=settle_s)
        return reports

    def stop_all(self) -> None:
        # peers first so their deliver loops stop hammering dead orderers
        for name in [n for n, (k, _) in self._specs.items() if k == "peer"]:
            node = self.nodes.pop(name, None)
            if node is not None:
                try:
                    node.stop()
                except Exception:
                    pass
        for name in list(self.nodes):
            node = self.nodes.pop(name)
            try:
                node.stop()
            except Exception:
                pass

    # -- topology views --------------------------------------------------

    def orderers(self) -> List:
        return [self.nodes[n] for n, (k, _) in self._specs.items()
                if k == "orderer" and n in self.nodes]

    def peers(self) -> List:
        return [self.nodes[n] for n, (k, _) in self._specs.items()
                if k == "peer" and n in self.nodes]

    def orderer_addr(self, name: str) -> Tuple[str, int]:
        _, path = self._specs[name]
        with open(path) as f:
            cfg = json.load(f)
        return (cfg["host"], int(cfg["port"]))

    def wait_for_leader(self, timeout_s: float = 60.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if any(o.support.chain.node.role == "leader"
                   for o in self.orderers()):
                return
            time.sleep(0.1)
        raise AssertionError("no raft leader within %.0fs" % timeout_s)

    def client(self, org: str = "Org1", peer_idx: int = 0,
               timeout: float = 5.0, call_timeout: float = 30.0):
        """GatewayClient bound to one running peer.  Raise the timeouts
        when the peers verify on a slow provider (e.g. the CUDA provider's
        plain CPU path, seconds per handshake/endorse on a 1-core host)."""
        from fabric_tpu_torch.gateway import GatewayClient
        from fabric_tpu_torch.node.orderer import load_signing_identity
        with open(self.paths["clients"][org]) as f:
            cc = json.load(f)
        signer = load_signing_identity(
            cc["mspid"], cc["cert_pem"].encode(), cc["key_pem"].encode())
        peer = self.peers()[peer_idx]
        return GatewayClient(peer.rpc.addr, signer, peer.msps,
                             channel_id=self.channel_id,
                             timeout=timeout, call_timeout=call_timeout)

    # -- convergence invariants ------------------------------------------

    def heights(self) -> Dict[str, int]:
        return {n: p.channels[self.channel_id].ledger.height
                for n, p in self.nodes.items()
                if self._specs[n][0] == "peer"}

    def commit_hashes(self, height: Optional[int] = None) -> Dict[str, str]:
        """Each peer's chained commit hash; with `height`, the hash of
        the block at height-1 so peers ahead of the slowest still
        compare equal prefixes."""
        out = {}
        for n, p in self.nodes.items():
            if self._specs[n][0] != "peer":
                continue
            ledger = p.channels[self.channel_id].ledger
            if height is None:
                out[n] = ledger.commit_hash.hex()
            else:
                from fabric_tpu_torch.protocol import block_header_hash
                blk = ledger.blockstore.get_by_number(height - 1)
                out[n] = block_header_hash(blk.header).hex()
        return out

    def wait_converged(self, timeout_s: float = 30.0,
                       min_height: Optional[int] = None) -> bool:
        """Block until every running peer reports the same height (>=
        min_height when given) AND identical commit hashes."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            hs = self.heights()
            if hs and len(set(hs.values())) == 1 and (
                    min_height is None
                    or next(iter(hs.values())) >= min_height):
                if len(set(self.commit_hashes().values())) == 1:
                    return True
            time.sleep(0.1)
        logger.error("chaos: convergence timed out: heights=%s hashes=%s",
                     self.heights(), self.commit_hashes())
        return False
