"""The shared world of the endorsement tests (tests/test_torch_endorse.py,
test_torch_scc.py): one channel of two application orgs, Org1 with
P-256 identities and Org2 with Ed25519 ones, built the same way on the
reference and on the port.

- `Ids`: every identity minted once, by the reference's `DevOrg`; each
  package holds the same certificates and keys (`intake_world`).
- `Peer`: one org's endorsing peer on package P: its own in-memory
  ledger, committer (TxValidator with the peer's
  `LifecyclePolicyProvider` as `policies`; the deep or the classic tail),
  privdata coordinator (collection `cc/secrets`, Org1 only; its hashed
  namespace `cc$secrets` has no `_lifecycle` definition, so it takes
  `cc`'s policy statically), transient
  and pvt stores, `ACLProvider` over the channel's `BundleSource`, the
  chaincode registry (`cc`, `cc2`, `_lifecycle`) and `Endorser`.
- `Duo`: the same world on both packages, driven in step (`deploy`
  first defines `cc` and `cc2` through `_lifecycle`): each signed
  proposal is made once (a P-256 signature differs from run to run) and
  goes to both packages' endorsers; each block is assembled once, from
  the reference's responses, and committed on every peer of both.  It
  holds the responses and, after every block, flags, state, history,
  pvt store, commit hash and `policy_for` equal (`compare_*`).
"""
import dataclasses

from fabric_tpu.bccsp import SCHEME_ED25519
from fabric_tpu.msp.ca import DevOrg

from intake_world import load, msps_for, signer_for

CHANNEL = "ch"
ORG_IDS = ("Org1", "Org2")
MAJORITY = "OutOf(2, 'Org1.member', 'Org2.member')"
CC_POLICY = "AND('Org1.member', 'Org2.member')"
ANY_ADMIN = "OR('Org1.admin', 'Org2.admin')"
COLLECTION = "secrets"
TS = 1_760_000_000            # envelope timestamps, fixed in both packages


@dataclasses.dataclass
class Ids:
    orgs: tuple               # reference DevOrgs
    peers: tuple              # one endorsing peer a org
    clients: tuple            # one client a org
    outsider: object          # a client of an org outside the channel


def mint() -> Ids:
    orgs = (DevOrg("Org1"), DevOrg("Org2", scheme=SCHEME_ED25519))
    return Ids(orgs=orgs,
               peers=tuple(o.new_identity(f"peer{i + 1}")
                           for i, o in enumerate(orgs)),
               clients=tuple(o.new_identity(f"client{i + 1}")
                             for i, o in enumerate(orgs)),
               outsider=DevOrg("Org9").new_identity("mallory"))


def bundle_source(P, ids: Ids, acls=None, sequence: int = 0):
    C = P.config
    orgs = []
    for o in ids.orgs:
        mc = o.msp_config()
        orgs.append(C.OrgConfig(mspid=o.mspid,
                                root_certs=tuple(mc.root_certs_pem),
                                admins=tuple(mc.admin_certs_pem)))
    policies = dict(C.default_policies(list(ORG_IDS)))
    policies["AnyAdmin"] = P.policy.parse_policy(ANY_ADMIN)
    return C.BundleSource(C.Bundle(C.ChannelConfig(
        channel_id=CHANNEL, sequence=sequence, orgs=tuple(orgs),
        policies=policies, acls=dict(acls or {}))))


def kv_contract(P):
    """The test chaincode on package P (tests/test_endorser.py's, plus
    private data); failures raise P's SimulationError."""
    Err = P.chaincode.SimulationError

    def put(stub, key, value):
        stub.put_state(key.decode(), value)
        return b"ok"

    def get(stub, key):
        v = stub.get_state(key.decode())
        if v is None:
            raise Err("no such key")
        return v

    def transfer(stub, frm, to, amt):
        a = int(stub.get_state(frm.decode()) or b"0")
        b = int(stub.get_state(to.decode()) or b"0")
        n = int(amt)
        if a < n:
            raise Err("insufficient funds")
        stub.put_state(frm.decode(), str(a - n).encode())
        stub.put_state(to.decode(), str(b + n).encode())
        return b"ok"

    def seed(stub, *pairs):
        for i in range(0, len(pairs), 2):
            stub.put_state(pairs[i].decode(), pairs[i + 1])
        return str(len(pairs) // 2).encode()

    def scan(stub, start, end):
        rows = stub.get_state_by_range(start.decode(), end.decode())
        return str(len(rows)).encode()

    def call_other(stub, cc, fn, *args):
        return stub.invoke_chaincode(cc.decode(), fn.decode(), list(args))

    def put_private(stub, key, value):
        stub.put_private_data(COLLECTION, key.decode(), value)
        stub.set_event("private", key)
        return b"ok"

    def get_private(stub, key):
        return stub.get_private_data(COLLECTION, key.decode()) or b""

    return P.runtime.FuncContract(
        put=put, get=get, transfer=transfer, seed=seed, scan=scan,
        call_other=call_other, put_private=put_private,
        get_private=get_private)


class Peer:
    """One org's endorsing peer on package P."""

    def __init__(self, P, ids: Ids, index: int, provider, msps,
                 classic: bool = False, acls=None):
        self.P, self.index = P, index
        org = ids.orgs[index]
        self.mspid = org.mspid
        self.signer = signer_for(P, ids.peers[index])
        self.ledger = P.ledger.KVLedger(CHANNEL, P.ledger.LedgerConfig())
        self.policies = P.lifecycle.LifecyclePolicyProvider(
            self.ledger.statedb, default=P.policy.parse_policy(MAJORITY))
        self.policies.set_policy(P.lifecycle.LIFECYCLE_NS,
                                 P.policy.parse_policy(MAJORITY))
        # a private write's hashed namespace has no `_lifecycle`
        # definition of its own: it takes the chaincode's policy
        self.policies.set_policy(
            P.collection.pvt_namespace("cc", COLLECTION),
            P.policy.parse_policy(CC_POLICY))
        R = P.runtime
        self.registry = R.ChaincodeRegistry()
        for name in ("cc", "cc2"):
            self.registry.install(R.ChaincodeDefinition(name, "1.0"),
                                  kv_contract(P))
        self.registry.install(
            R.ChaincodeDefinition(P.lifecycle.LIFECYCLE_NS, "1.0"),
            P.lifecycle.LifecycleContract(list(ORG_IDS)))
        self.source = bundle_source(P, ids, acls)
        self.acl = P.acl.ACLProvider(self.source, provider)
        sbe = P.sbe.statedb_lookup(self.ledger.statedb) if classic else None
        validator = P.committer.TxValidator(
            CHANNEL, msps, provider, self.policies, sbe_lookup=sbe)
        self.committer = P.committer.Committer(self.ledger, validator)
        self.collections = P.collection.CollectionRegistry()
        self.collections.define("cc", P.collection.CollectionConfig(
            COLLECTION, member_orgs=("Org1",)))
        self.transient = P.privdata.TransientStore()
        self.pvt = P.privdata.PvtDataStore()
        self.coordinator = P.privdata.Coordinator(
            self.committer, self.collections, self.transient, self.pvt,
            mspid=self.mspid)
        self.endorser = P.endorser.Endorser(
            CHANNEL, self.ledger.statedb, self.registry, msps, provider,
            self.signer, transient_store=self.transient,
            pvt_store=self.pvt, ledger_height=lambda: self.ledger.height,
            acl=self.acl)
        self.results = []

    def rows(self) -> tuple:
        """State, history, pvt store, transient count, commit hash,
        height."""
        led = self.ledger
        state = sorted((k, None if vv is None else
                        (vv.value, vv.version.block_num, vv.version.tx_num))
                       for k, vv in led.statedb._data.items())
        hist = led.historydb
        history = {k: [(m.block_num, m.tx_num, m.txid, m.value,
                        m.is_delete) for m in hist.get_history(*k)]
                   for k in sorted(hist._index)}
        pvt = (sorted(self.pvt._state.items()),
               sorted(self.pvt._by_txid.items()))
        return (state, history, pvt, len(self.transient), led.commit_hash,
                led.height)


def policy_bytes(pol):
    return None if pol is None else pol.serialize()


class Duo:
    """The world on both packages, driven in step."""

    def __init__(self, ids: Ids, classic: bool = False, acls=None,
                 providers=None):
        self.ids = ids
        self.P = {pkg: load(pkg) for pkg in ("ref", "port")}
        self.peers = {}
        for pkg, P in self.P.items():
            prov = (providers or {}).get(pkg) or P.factory.init_factories(
                P.factory.FactoryOpts(default="SW"))
            msps = msps_for(P, ids.orgs)
            self.peers[pkg] = [Peer(P, ids, i, prov, msps, classic, acls)
                               for i in range(len(ids.orgs))]

    def deploy(self, names=("cc", "cc2"), policy: str = CC_POLICY) -> None:
        """Each chaincode of `names` defined through `_lifecycle`: both
        orgs' admins approve (one block), Org1's admin commits (the next),
        so every peer's `policy_for` reads it from committed state."""
        pol = self.P["ref"].policy.parse_policy(policy).serialize()
        for fn, orgs in (("approve_for_org", (0, 1)), ("commit", (0,))):
            envs = []
            for name in names:
                for org in orgs:
                    admin = self.ids.orgs[org].admin
                    sp = self.proposal(admin, "_lifecycle", fn,
                                       [name.encode(), b"1.0", b"1", pol])
                    envs.append(self.envelope(sp, self.endorse(sp), admin))
            assert self.commit(envs) == [0] * len(envs)

    # -- proposals ------------------------------------------------------------

    def proposal(self, client, cc: str, fn: str, args, nonce=None):
        """One signed proposal, made once by the reference."""
        R = self.P["ref"]
        return R.proposal.signed_proposal(CHANNEL, cc, fn, list(args),
                                          client, nonce=nonce)

    def endorse(self, sp, endorsers=(0, 1)) -> dict:
        """`sp` through each package's endorsers in turn -> {pkg:
        responses}; the two packages' responses held equal."""
        out = {}
        for pkg, P in self.P.items():
            psp = P.proposal.SignedProposal(sp.proposal_bytes, sp.signature)
            out[pkg] = [self.peers[pkg][i].endorser.process_proposal(psp)
                        for i in endorsers]
        for r, p in zip(out["ref"], out["port"]):
            compare_response(self.P, self.ids, r, p)
        return out

    def envelope(self, sp, resps, client):
        """The reference's assembled envelope; the port's assembly on the
        port's responses must succeed too, and for an Ed25519 client, on
        the reference's responses (the same endorsements), give the same
        bytes."""
        R, Pt = self.P["ref"], self.P["port"]
        env = R.proposal.assemble_transaction(sp, resps["ref"], client)
        psp = Pt.proposal.SignedProposal(sp.proposal_bytes, sp.signature)
        pclient = signer_for(Pt, client)
        Pt.proposal.assemble_transaction(psp, resps["port"], pclient)
        if client.mspid == "Org2":
            same = [Pt.proposal.ProposalResponse(
                r.status, r.message, r.payload, Pt.types.Endorsement(
                    r.endorsement.endorser, r.endorsement.signature))
                for r in resps["ref"]]
            penv = Pt.proposal.assemble_transaction(psp, same, pclient)
            assert penv.serialize() == env.serialize()
        return env

    def assembly_error(self, sp, resps, client) -> str:
        """Both packages refuse the assembly with the same message."""
        got = {}
        for pkg, P in self.P.items():
            psp = P.proposal.SignedProposal(sp.proposal_bytes, sp.signature)
            try:
                P.proposal.assemble_transaction(
                    psp, resps[pkg], signer_for(P, client))
                got[pkg] = None
            except P.proposal.ResponseMismatchError as exc:
                got[pkg] = str(exc)
        assert got["ref"] is not None and got["ref"] == got["port"]
        return got["ref"]

    # -- blocks -----------------------------------------------------------------

    def commit(self, envs) -> list:
        """One block of `envs`, built once, committed on every peer of both
        packages through its coordinator -> the flags; every peer's flags
        and rows equal across the packages, and the two peers of a
        package agree on flags, state and commit hash."""
        R = self.P["ref"]
        led = self.peers["ref"][0].ledger
        prev = (led.blockstore.chain_info().current_hash if led.height
                else b"\x00" * 32)
        raw = R.build.new_block(led.height, prev, list(envs)).serialize()
        flags = {}
        for pkg, P in self.P.items():
            for peer in self.peers[pkg]:
                res = peer.coordinator.store_block(P.protocol.Block
                                                   .deserialize(raw))
                peer.results.append(res)
                flags[(pkg, peer.index)] = list(res.final_flags.codes())
        self.compare_peers()
        codes = flags[("ref", 0)]
        assert all(f == codes for f in flags.values()), flags
        return codes

    def compare_peers(self) -> None:
        for rp, pp in zip(self.peers["ref"], self.peers["port"]):
            assert rp.rows() == pp.rows(), f"peer {rp.index}: rows differ"
            for ns in ("cc", "cc2", "newcc", self.P["ref"].lifecycle
                       .LIFECYCLE_NS):
                assert (policy_bytes(rp.policies.policy_for(ns))
                        == policy_bytes(pp.policies.policy_for(ns))), ns
        for pkg in self.P:
            a, b = self.peers[pkg]
            ra, rb = a.rows(), b.rows()
            assert ra[0] == rb[0] and ra[4] == rb[4]

    def state(self, pkg: str, key: str, ns: str = "cc"):
        return self.peers[pkg][0].ledger.get_state(ns, key)


def compare_response(P, ids: Ids, r, p) -> None:
    """Status, message, payload and endorser bytes equal; each package's
    endorsement signature verifies on both packages' SW; an Ed25519
    endorser's responses are byte-equal."""
    assert (r.status, r.message, r.payload) == (p.status, p.message,
                                                p.payload)
    assert (r.endorsement is None) == (p.endorsement is None)
    if r.endorsement is None:
        return
    assert r.endorsement.endorser == p.endorsement.endorser
    for Q in P.values():
        msps = msps_for(Q, ids.orgs)
        ident = Q.msp.deserialize_from_msps(msps, r.endorsement.endorser,
                                            validate=True)
        for e, payload in ((r.endorsement, r.payload),
                           (p.endorsement, p.payload)):
            assert ident.verify(payload + e.endorser, e.signature)
    if ident.mspid == "Org2":
        assert r.endorsement.signature == p.endorsement.signature
