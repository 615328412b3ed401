"""The port's out-of-process chaincode (fabric_tpu_torch.chaincode.extcc,
.externalbuilder, the package store of .lifecycle, and
runtime.ExternalContract) against the reference's, on the CPU.

* The reference's own scenarios on both packages: every test function
  of tests/test_extcc.py and tests/test_externalbuilder.py, its source
  with the package's imports pointing at the package, the chaincode
  scripts it writes included, so each package's peer drives its own
  package's chaincode process (tests/ref_scenarios.py).
* Across the packages, both directions: each package's
  `ChaincodeSupport` drives a chaincode process of each package over the
  shim protocol (register with the launch token, every callback of the
  FSM, a contract error, a crash and relaunch); `ExternalContract` (one
  process a call, request on stdin, ops on stdout) with each package's
  runner script; packages, package ids and the installer's store; the
  builder pipeline's detect / build / release results (the builtin
  python builder, an operator builder directory, an undetected package).

Held: payloads, errors, staged rwsets (serialised), events and private
sets equal across all four support x chaincode pairings; package bytes,
ids, build results and release files equal.  Every wait is bounded by
the support's launch and invoke timeouts (15 s) or a subprocess timeout.
Tolerance: exact equality.
"""
import os
import sys
import textwrap

import pytest

from intake_world import load
from ref_scenarios import PKGS, run_scenario, scenario_module, scenario_names

REF_FILES = ("test_extcc", "test_externalbuilder")
RUNS = [(f, t, p) for f in REF_FILES for t in scenario_names(f)
        for p in PKGS]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("ref", "port")
TIMEOUT_S = 15.0


@pytest.mark.parametrize("case,name,pkg", RUNS,
                         ids=[f"{f}::{t}-{p}" for f, t, p in RUNS])
def test_reference_scenario(case, name, pkg, request):
    run_scenario(scenario_module(case, pkg), name, request)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pk():
    return {side: load(side) for side in SIDES}


CC_SCRIPT = textwrap.dedent("""\
    import sys
    sys.path.insert(0, %(repo)r)
    from %(root)s.chaincode.extcc import shim_main

    def invoke(stub, fn, args):
        if fn == "put":
            stub.put_state(args[0].decode(), args[1])
            stub.set_event("put_event", args[0])
            return b"done"
        if fn == "get":
            return stub.get_state(args[0].decode()) or b"<missing>"
        if fn == "move":
            v = stub.get_state(args[0].decode())
            stub.del_state(args[0].decode())
            stub.put_state(args[1].decode(), v or b"")
            return b"moved"
        if fn == "pvt":
            stub.put_private_data("secrets", args[0].decode(), args[1])
            stub.del_private_data("secrets", "old")
            return stub.get_private_data("secrets", args[0].decode())
        if fn == "scan":
            items = stub.get_state_by_range(args[0].decode(),
                                            args[1].decode())
            return b",".join(k.encode() + b"=" + v for k, v in items)
        if fn == "boom":
            raise ValueError("kaboom")
        if fn == "die":
            import os
            os._exit(1)
        raise ValueError("unknown fn")

    shim_main(invoke)
""")

CALLS = (("put", [b"k1", b"v1"]), ("get", [b"a"]), ("get", [b"nope"]),
         ("move", [b"a", b"b2"]), ("pvt", [b"sk", b"sv"]),
         ("scan", [b"a", b"z"]))


def committed_db(P):
    """A state database holding cc/a and cc/c at block 1."""
    db = P.statedb.StateDB()
    batch = P.statedb.UpdateBatch()
    for i, k in enumerate(("a", "c")):
        batch.put("cc", k, f"val-{k}".encode(), P.protocol.Version(1, i))
    db.apply_updates(batch, 1)
    return db


def drive(P, root_cc: str, tmp_path) -> list:
    """Package P's ChaincodeSupport driving a chaincode process whose
    shim is package `root_cc`'s -> per call (payload or error, rwset
    bytes, event bytes, private sets)."""
    # short names: the socket's path must fit AF_UNIX's ~107 bytes
    d = tmp_path / f"{P.name[0]}{root_cc[-1]}"
    d.mkdir()
    script = d / "cc.py"
    script.write_text(CC_SCRIPT % {"repo": REPO, "root": root_cc})
    sup = P.extcc.ChaincodeSupport(str(d / "s"),
                                   launch_timeout_s=TIMEOUT_S,
                                   invoke_timeout_s=TIMEOUT_S)
    out = []
    try:
        contract = P.extcc.ExtProcessContract(
            sup, "cc", [sys.executable, str(script)])
        db = committed_db(P)
        for i, (fn, args) in enumerate(CALLS + (("boom", []),)):
            stub = P.stub.ChaincodeStub(db, "cc", channel_id="ch",
                                        txid=f"tx{i}")
            try:
                res = contract.invoke(stub, fn, args)
            except P.chaincode.SimulationError as exc:
                res = f"error: {exc}"
            out.append((res, stub.rwset().serialize(), stub.event_bytes(),
                        stub.private_sets()))
        # a crash fails its invoke; the next one relaunches the process
        with pytest.raises(P.chaincode.SimulationError):
            contract.invoke(P.stub.ChaincodeStub(db, "cc"), "die", [])
        out.append(contract.invoke(P.stub.ChaincodeStub(db, "cc"), "get",
                                   [b"c"]))
    finally:
        sup.stop()
    return out


def test_support_and_chaincode_across_packages(pk, tmp_path):
    """Every pairing of a package's ChaincodeSupport with a package's
    chaincode process gives the same results."""
    got = {(side, cc): drive(pk[side], pk[cc].root, tmp_path)
           for side in SIDES for cc in SIDES}
    want = got[("ref", "ref")]
    assert want[-2][0] == "error: kaboom" and want[-1] == b"val-c"
    assert want[0][0] == b"done" and b"put_event" in want[0][2]
    for key, rows in got.items():
        assert rows == want, key


RUNNER = textwrap.dedent("""\
    import sys
    sys.path.insert(0, %(repo)r)
    from %(root)s.utils import serde

    req = serde.decode(sys.stdin.buffer.read())
    ops = [{"op": "put", "key": "fn", "value": req["fn"].encode()},
           {"op": "put", "key": "txid", "value": req["txid"].encode()},
           {"op": "del", "key": "gone"}]
    if req["fn"] == "fail":
        sys.exit(3)
    sys.stdout.buffer.write(serde.encode(
        {"ops": ops, "payload": b"|".join(req["args"])}))
""")


def test_external_contract_one_process_a_call(pk, tmp_path):
    """runtime.ExternalContract of each package with a runner script of
    each package: payload and staged rwset equal; a failing process is a
    SimulationError with the same text."""
    got = {}
    for side in SIDES:
        for runner in SIDES:
            P = pk[side]
            script = tmp_path / f"run-{side}-{runner}.py"
            script.write_text(RUNNER % {"repo": REPO,
                                        "root": pk[runner].root})
            contract = P.runtime.ExternalContract(
                [sys.executable, str(script)], timeout_s=TIMEOUT_S)
            stub = P.stub.ChaincodeStub(P.statedb.StateDB(), "cc",
                                        channel_id="ch", txid="t1")
            payload = contract.invoke(stub, "go", [b"x", b"y"])
            with pytest.raises(P.chaincode.SimulationError) as exc:
                contract.invoke(P.stub.ChaincodeStub(P.statedb.StateDB(),
                                                     "cc"), "fail", [])
            msg = str(exc.value).replace(str(script), "<script>")
            got[(side, runner)] = (payload, stub.rwset().serialize(), msg)
    want = got[("ref", "ref")]
    assert want[0] == b"x|y" and "exit status 3" in want[2]
    assert all(v == want for v in got.values()), got


def test_packages_ids_and_installer_equal(pk, tmp_path):
    rows = {}
    for side in SIDES:
        L = pk[side].lifecycle
        pkg = L.package_chaincode("assets_1.0", b"print('cc')",
                                  {"type": "python", "n": 3})
        inst = L.ChaincodeInstaller(str(tmp_path / side))
        pid = inst.install(pkg)
        path = inst._path(pid)
        with open(path, "r+b") as f:
            f.seek(10)
            f.write(b"\xff")
        with pytest.raises(ValueError) as exc:
            inst.get(pid)
        with pytest.raises(ValueError) as bad:
            L.package_chaincode("bad/label", b"")
        rows[side] = (pkg, pid, os.path.basename(path), inst.installed(),
                      str(exc.value), str(bad.value))
    assert rows["port"] == rows["ref"]


def _operator_builder(root):
    bdir = root / "mybuilder"
    (bdir / "bin").mkdir(parents=True)
    scripts = {
        "detect": "#!/bin/sh\ngrep -q mylang \"$2\"/metadata.json\n",
        "build": "#!/bin/sh\ncp \"$1\"/code \"$3\"/cc.py\n",
        "run": f"#!/bin/sh\nexec {sys.executable} \"$1\"/cc.py\n"}
    for name, text in scripts.items():
        path = bdir / "bin" / name
        path.write_text(text)
        path.chmod(0o755)
    return bdir


def _tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_builders_give_the_same_results(pk, tmp_path):
    """detect / build / release on both packages: the builtin python
    builder, an operator builder that wins on its own metadata type, a
    cached rebuild and an undetected package -> the same builder names,
    run commands (relative to each build root), release files and
    errors."""
    rows = {}
    for side in SIDES:
        P = pk[side]
        root = tmp_path / side
        builder = _operator_builder(root)
        L, B = P.lifecycle, P.extbuilder
        pipe = B.BuildPipeline(str(root / "builds"),
                               [B.ExternalBuilder("mybuilder",
                                                  str(builder))])
        out = []
        for label, meta in (("asset.py", {"type": "python"}),
                            ("asset", {"type": "mylang"})):
            pkg = L.package_chaincode(label, b"print('cc')\n", meta)
            res = pipe.build(pkg)
            again = pipe.build(pkg)
            assert again == res
            rel = [a.replace(str(root), "<root>") for a in res.run_argv]
            out.append((res.package_id, res.builder, rel,
                        _tree(res.output_dir)))
        with pytest.raises(RuntimeError) as exc:
            pipe.build(L.package_chaincode("asset.wasm", b"\x00",
                                           {"type": "wasm"}))
        out.append(str(exc.value))
        rows[side] = out
    assert rows["port"] == rows["ref"]
    assert [r[1] for r in rows["port"][:2]] == ["python-builtin",
                                                "mybuilder"]
