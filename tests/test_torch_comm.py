"""The port's authenticated RPC plane (fabric_tpu_torch.comm, the secure
channel's crypto in fabric_tpu_torch.crypto, serde.decode_views) against
the reference's, on the CPU.

- HKDF (RFC 5869 case 1 and seeded inputs), the AEAD in both modes and
  X25519 (RFC 7748's vectors, its 1,000-step iteration and its
  Diffie-Hellman example): the port's bytes equal the reference's.
- The secure channel across packages in both directions (a port client
  against a reference `RpcServer`, a reference client against a port
  one) and both crypto modes: unary, stream (`stream_views`), cast; the
  handshake-verified org on both ends; a rogue org refused at the
  handshake, client side and server side.
- One seeded fault plan gives the same drop, delay, dup, reorder and
  error decisions in both packages, frame by frame.
- `decode_views` against the reference's and against the C codec's
  accept/reject, and the port's `wire.parse_block` on the memoryview it
  yields.

Every socket wait has its own timeout (a queue get or an RPC deadline of
5 s); servers bind port 0 and stop in a `finally`.  Handshakes verify
through each package's default provider, SW here (the CUDA provider's
handshake is a GPU test in tests/test_torch_cuda.py).  Tolerance: exact
equality throughout."""
import queue
import random

import pytest

from fabric_tpu.msp.ca import DevOrg

from intake_world import MODES, PKGS, load, msps_for, set_mode, signer_for


@pytest.fixture(scope="module")
def pk():
    out = {name: load(name) for name in PKGS}
    for P in out.values():
        P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
    return out


@pytest.fixture(scope="module")
def orgs():
    return DevOrg("Org1"), DevOrg("Org2")


@pytest.fixture(scope="module")
def idents(orgs):
    return {"srv": orgs[0].new_identity("server"),
            "cli": orgs[1].new_identity("client")}


# -- primitives --------------------------------------------------------------

def test_hkdf_matches_reference_and_rfc5869(pk):
    h = bytes.fromhex
    okm = ("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf"
           "34007208d5b887185865")
    for P in pk.values():
        assert P.aead.hkdf_sha256(b"\x0b" * 22, h("000102030405060708090a0b0c"),
                                  h("f0f1f2f3f4f5f6f7f8f9"), 42).hex() == okm
    rng = random.Random(17)
    for _ in range(40):
        args = (rng.randbytes(rng.randrange(0, 80)),
                rng.randbytes(rng.choice([0, 16, 32, 77])),
                rng.randbytes(rng.randrange(0, 40)),
                rng.choice([1, 16, 32, 33, 64, 100, 255 * 32]))
        assert (pk["port"].aead.hkdf_sha256(*args)
                == pk["ref"].aead.hkdf_sha256(*args))
    for P in pk.values():
        with pytest.raises(ValueError):
            P.aead.hkdf_sha256(b"k", b"", b"", 255 * 32 + 1)


@pytest.mark.parametrize("mode", MODES)
def test_aead_matches_reference(pk, monkeypatch, mode):
    set_mode(monkeypatch, mode)
    rng = random.Random(29)
    for n in (0, 1, 31, 32, 33, 100, 4096 + 7):
        key, nonce = rng.randbytes(32), rng.randbytes(12)
        data, aad = rng.randbytes(n), rng.randbytes(rng.choice([0, 5, 64]))
        port, ref = pk["port"].aead.Aead(key), pk["ref"].aead.Aead(key)
        ct = port.encrypt(nonce, data, aad)
        assert ct == ref.encrypt(nonce, data, aad) and len(ct) == n + 16
        assert ref.decrypt(nonce, ct, aad) == data
        assert port.decrypt(nonce, ct, aad) == data
        bad = bytearray(ct)
        bad[rng.randrange(len(bad))] ^= 1
        for a in (port, ref):
            with pytest.raises(ValueError):
                a.decrypt(nonce, bytes(bad), aad)
            with pytest.raises(ValueError):
                a.decrypt(nonce, ct[:15], aad)
    for P in pk.values():
        with pytest.raises(ValueError):
            P.aead.Aead(b"short")


def test_aead_modes_differ(pk, monkeypatch):
    """The two modes are not wire-compatible (`aead.py`'s docstring):
    a lite ciphertext does not decrypt under ChaCha20-Poly1305."""
    key, nonce = b"k" * 32, b"n" * 12
    chacha = pk["port"].aead.Aead(key).encrypt(nonce, b"payload")
    set_mode(monkeypatch, "lite")
    lite = pk["port"].aead.Aead(key)
    assert lite.encrypt(nonce, b"payload") != chacha
    with pytest.raises(ValueError):
        lite.decrypt(nonce, chacha)


RFC7748 = (
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
)


def test_x25519_rfc7748_vectors(pk):
    h = bytes.fromhex
    X = pk["port"].x25519
    for k, u, out in RFC7748:
        assert X.x25519(h(k), h(u)).hex() == out
        assert pk["ref"].x25519.x25519(h(k), h(u)).hex() == out
    # section 5.2's iteration: after 1 and 1,000 steps
    k = u = (9).to_bytes(32, "little")
    for i in range(1000):
        k, u = X.x25519(k, u), k
        if i == 0:
            assert k.hex() == ("422c8e7a6227d7bca1350b3e2bb7279f"
                               "7897b87bb6854b783c60e80311ae3079")
    assert k.hex() == ("684cf59ba83309552800ef566f2f4d3c"
                       "1c3887c49360e3875f2eb94d99532c51")
    # section 6.1's Diffie-Hellman, through the lite key classes
    L = pk["port"].lite_x25519
    a = L.X25519PrivateKey.from_private_bytes(h(
        "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"))
    b = L.X25519PrivateKey.from_private_bytes(h(
        "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"))
    assert a.public_key().public_bytes_raw().hex() == (
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert b.public_key().public_bytes_raw().hex() == (
        "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    shared = a.exchange(b.public_key())
    assert shared == b.exchange(a.public_key())
    assert shared.hex() == ("4a5d9d5ba4ce2de1728e3bf480350f25"
                            "e07e21c947d19e3376f09b3c1e161742")
    with pytest.raises(ValueError):
        a.exchange(L.X25519PublicKey(b"\x00" * 32))   # the zero point


def test_x25519_lite_matches_reference_and_library(pk):
    from cryptography.hazmat.primitives.asymmetric import x25519 as lib
    rng = random.Random(31)
    PL, RL = pk["port"].lite_x25519, pk["ref"].lite_x25519
    for _ in range(8):
        sa, sb = rng.randbytes(32), rng.randbytes(32)
        pa, ra = (PL.X25519PrivateKey.from_private_bytes(sa),
                  RL.X25519PrivateKey.from_private_bytes(sa))
        pb = PL.X25519PrivateKey.from_private_bytes(sb)
        assert (pa.public_key().public_bytes_raw()
                == ra.public_key().public_bytes_raw()
                == lib.X25519PrivateKey.from_private_bytes(sa).public_key()
                .public_bytes_raw())
        shared = pa.exchange(pb.public_key())
        assert shared == ra.exchange(RL.X25519PublicKey(
            pb.public_key().public_bytes_raw()))
        assert shared == lib.X25519PrivateKey.from_private_bytes(
            sb).exchange(lib.X25519PublicKey.from_public_bytes(
                pa.public_key().public_bytes_raw()))


def test_crypto_shim_exports_the_channel_names(pk):
    import fabric_tpu_torch.crypto as C
    ref = pk["ref"]
    assert C.Aead is pk["port"].aead.Aead
    assert C.hkdf_sha256 is pk["port"].aead.hkdf_sha256
    # chosen as the reference chooses them: cryptography's when present
    import fabric_tpu.crypto as R
    assert C.HAVE_CRYPTOGRAPHY == R.HAVE_CRYPTOGRAPHY
    assert C.X25519PrivateKey is R.X25519PrivateKey
    assert ref.secure.X25519PrivateKey is R.X25519PrivateKey
    assert pk["port"].secure.X25519PrivateKey is C.X25519PrivateKey


# -- the secure channel across packages ---------------------------------------

DIRECTIONS = (("port", "ref"), ("ref", "port"))     # (client, server)


def _server(P, signer, msps, casts):
    srv = P.rpc.RpcServer("127.0.0.1", 0, signer, msps)
    srv.serve("echo", lambda body, ident: {
        "x": body["x"], "who": ident.mspid})
    srv.serve_stream("count", lambda body, ident: (
        {"n": i, "blob": bytes([i]) * (i * 1000)}
        for i in range(int(body["n"]))))
    srv.serve_cast("note", lambda body, ident: casts.put(
        (body["x"], ident.mspid)))
    return srv.start()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_secure_channel_across_packages(pk, orgs, idents, monkeypatch, mode,
                                        cli, srv):
    set_mode(monkeypatch, mode)
    C, S = pk[cli], pk[srv]
    casts = queue.Queue()
    server = _server(S, signer_for(S, idents["srv"]), msps_for(S, orgs),
                     casts)
    try:
        for views in (False, True):
            conn = C.rpc.connect(server.addr, signer_for(C, idents["cli"]),
                                 msps_for(C, orgs), timeout=5.0,
                                 stream_views=views)
            try:
                assert conn.channel.peer_identity.mspid == "Org1"
                out = conn.call("echo", {"x": b"hello" * 100}, timeout=5.0)
                assert bytes(out["x"]) == b"hello" * 100
                assert out["who"] == "Org2"
                got = list(conn.call_stream("count", {"n": 5}))
                assert [g["n"] for g in got] == list(range(5))
                assert [bytes(g["blob"]) for g in got] == [
                    bytes([i]) * (i * 1000) for i in range(5)]
                if views:
                    assert all(isinstance(g["blob"], memoryview)
                               for g in got)
                conn.cast("note", {"x": 7})
                assert casts.get(timeout=5.0) == (7, "Org2")
            finally:
                conn.close()
    finally:
        server.stop()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_rogue_org_refused_at_handshake(pk, orgs, idents, monkeypatch, mode,
                                        cli, srv):
    set_mode(monkeypatch, mode)
    C, S = pk[cli], pk[srv]
    evil = DevOrg("Evil")
    rogue = evil.new_identity("rogue")
    casts = queue.Queue()
    server = _server(S, signer_for(S, idents["srv"]), msps_for(S, orgs),
                     casts)
    try:
        # a rogue client (which trusts the server's org) gets past its own
        # check, but the server refuses its identity and drops the socket
        conn = C.rpc.connect(server.addr, signer_for(C, rogue),
                             msps_for(C, (evil,) + orgs), timeout=5.0)
        try:
            with pytest.raises(C.rpc.RpcClosed):
                conn.call("echo", {"x": b"x"}, timeout=5.0)
        finally:
            conn.close()
        assert casts.empty()
    finally:
        server.stop()
    # a client refuses a rogue server at the handshake itself
    server = _server(S, signer_for(S, rogue), msps_for(S, (evil,) + orgs),
                     casts)
    try:
        with pytest.raises(C.secure.HandshakeError):
            C.rpc.connect(server.addr, signer_for(C, idents["cli"]),
                          msps_for(C, orgs), timeout=5.0)
    finally:
        server.stop()


# -- the fault plane -------------------------------------------------------------

def _fault_trace(P, seed: int):
    plan = P.faults.FaultPlan(seed=seed, clock=lambda: 100.0)
    plan.rule(method="deliver", kind="stream", drop=0.15, dup=0.15,
              reorder=0.1, delay=0.1, delay_s=0.0)
    plan.rule(method="gossip.msg/*", drop=0.3, error=0.1, max_fires=25)
    plan.rule(method="*", src="Org2", dup=0.05,
              schedule={"kind": "burst", "period_s": 10.0, "duty": 0.5})
    plan.installed_at = 95.0
    sent, errors = [], []
    methods = ("deliver", "gossip.msg/gossip.block", "gossip.msg/x", "echo")
    for i in range(300):
        method = methods[i % len(methods)]
        kind = "stream" if method == "deliver" else "cast"
        try:
            plan.apply(i % 3, method, ("127.0.0.1", 7000 + i % 2), kind,
                       lambda i=i: sent.append(i),
                       src="Org2" if i % 5 else "Org1")
        except P.faults.FaultInjected:
            errors.append(i)
    snap = plan.snapshot()
    return sent, errors, snap["fired"], [r["fires"] for r in snap["rules"]]


def test_fault_plan_same_decisions(pk):
    for seed in (0, 7, 12345):
        port = _fault_trace(pk["port"], seed)
        assert port == _fault_trace(pk["ref"], seed)
        assert port[2]["drop"] and port[2]["dup"] and port[2]["reorder"]
        assert port[1]          # some errors fired


def test_fault_plan_drops_a_unary_call_across_packages(pk, orgs, idents):
    """A port client under an installed plan that drops `echo` sees
    RpcTimeout against a reference server; after uninstall it goes
    through."""
    P, R = pk["port"], pk["ref"]
    server = _server(R, idents["srv"], msps_for(R, orgs), queue.Queue())
    try:
        conn = P.rpc.connect(server.addr, signer_for(P, idents["cli"]),
                             msps_for(P, orgs), timeout=5.0)
        try:
            P.faults.install(P.faults.FaultPlan(seed=1).rule(
                method="echo", drop=1.0))
            try:
                with pytest.raises(P.rpc.RpcTimeout):
                    conn.call("echo", {"x": b"a"}, timeout=0.5)
                assert P.faults.active().fired["drop"] == 1
            finally:
                P.faults.uninstall()
            assert bytes(conn.call("echo", {"x": b"b"}, timeout=5.0)["x"]) \
                == b"b"
        finally:
            conn.close()
    finally:
        server.stop()


# -- serde.decode_views ------------------------------------------------------

def _value(rng, depth=0):
    k = rng.randrange(8 if depth < 3 else 6)
    if k == 0:
        return None
    if k == 1:
        return rng.random() < 0.5
    if k == 2:
        return rng.choice([0, -1, 2 ** 63 - 1, -2 ** 63, 2 ** 70,
                           rng.randrange(-10 ** 6, 10 ** 6)])
    if k == 3:
        return rng.randbytes(rng.randrange(0, 40))
    if k == 4:
        return "".join(rng.choice("aé中z") for _ in range(rng.randrange(6)))
    if k == 5:
        return b""
    if k == 6:
        return [_value(rng, depth + 1) for _ in range(rng.randrange(4))]
    return {f"k{rng.randrange(50)}": _value(rng, depth + 1)
            for _ in range(rng.randrange(4))}


def _plain(v):
    if isinstance(v, memoryview):
        return ("B", v.tobytes(), v.readonly)
    if isinstance(v, bytes):
        return ("B", v, True)
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def _outcome(fn, data):
    try:
        return ("ok", _plain(fn(data)))
    except (ValueError, TypeError, RecursionError) as exc:
        return ("err", type(exc).__name__)


def test_decode_views_matches_reference(pk):
    P, R = pk["port"].serde, pk["ref"].serde
    rng = random.Random(41)
    for _ in range(300):
        data = R.encode(_value(rng))
        assert P.encode(R.decode(data)) == data
        got = P.decode_views(data)
        assert _plain(got) == _plain(R.decode_views(data))
        assert _plain(got) == _plain(P.decode(data))
        for _ in range(3):      # mutations: same accept/reject everywhere
            bad = bytearray(data)
            i = rng.randrange(len(bad))
            bad[i] = rng.randrange(256)
            bad = bytes(bad[:rng.randrange(len(bad) + 1)]) \
                if rng.random() < 0.3 else bytes(bad)
            port = _outcome(P.decode_views, bad)
            assert port[0] == _outcome(R.decode_views, bad)[0]
            assert port[0] == _outcome(P.decode, bad)[0]
            if port[0] == "ok":
                assert port == _outcome(R.decode_views, bad)
    deep = b"L\x00\x00\x00\x01" * 70 + b"N"
    for fn in (P.decode_views, R.decode_views, P.decode):
        with pytest.raises(ValueError):
            fn(deep)


def test_parse_block_takes_the_view(pk):
    """The deliver frame's block, decoded with `decode_views`, goes to
    the port's native span parser as the memoryview it is."""
    P = pk["port"]
    envs = [P.build.signed_envelope("t", "ch", {"i": i, "pad": b"x" * i},
                                    signer_for(P, DevOrg("Org1").admin))
            for i in range(5)]
    raw = P.build.new_block(3, b"\x01" * 32, envs).serialize()
    frame = P.serde.encode({"kind": "stream", "id": 1,
                            "body": {"block": raw}, "done": False})
    view = P.serde.decode_views(frame)["body"]["block"]
    assert isinstance(view, memoryview) and view.readonly
    block = P.wire.parse_block(view)
    assert isinstance(block, P.wire.BlockView)
    ref = P.wire.parse_block(raw)
    assert block.header.number == 3 and block.n_data == 5
    assert block.data == ref.data and block.hash() == ref.hash()
    assert bytes(block.serialize()) == raw
    assert block.computed_data_hash == ref.computed_data_hash
