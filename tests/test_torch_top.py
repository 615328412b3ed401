"""The port's cluster dashboard (fabric_tpu_torch.node.top) against the
reference's (fabric_tpu.node.top), on the CPU.

Differentials, the same inputs through both packages' `top`, the
outputs held equal as strings or values:

- `parse_metrics` over the /metrics text a port OperationsServer serves
  (a port peer's series: ledger height, commits, lane and pad slots by
  lane and `device="cuda:0"`, demotions by reason, the gateway's shed
  and admission series, resources) and over a seeded exposition with
  escaped label values, comments, histograms and special values;
- `collect_node` on that server (every cell the row reads), and on an
  address nothing listens on;
- `sort_rows` and `render` for every sort key of `_SORT_KEYS`, over
  seeded rows (some cells missing, some nodes down), and with a spark
  column;
- every `_fmt_*` cell and `_sparkline` over seeded rows;
- `main(["--targets", addr, "--once"])`: the frame printed, the clock in
  its header aside.

The reference's own top tests (tests/test_ops_plane.py's
`test_top_collect_and_render` and `test_label_value_escaping`,
tests/test_byzantine.py's `test_top_byz_column_formats`) run on the port
in tests/test_torch_ops_plane.py and tests/test_torch_byzantine.py.
"""
import importlib
import random

import pytest

from fabric_tpu.node import top as ref_top

from fabric_tpu_torch.node import top as port_top
from fabric_tpu_torch.ops_plane import MetricsRegistry, OperationsServer

SEED = 21
FMTS = ("_fmt_pair", "_fmt_pct", "_fmt_devices", "_fmt_shed", "_fmt_byz",
        "_fmt_inc", "_fmt_life", "_fmt_state", "_fmt_devval", "_fmt_res",
        "_sparkline")
ROW_FMTS = {"_fmt_shed", "_fmt_byz", "_fmt_inc", "_fmt_life", "_fmt_state",
            "_fmt_devval", "_fmt_res"}


def peer_registry() -> MetricsRegistry:
    """A port peer's series as its /metrics serves them."""
    reg = MetricsRegistry()
    reg.gauge("ledger_height").set(23, channel="ch")
    reg.counter("committed_txs_total").add(10512, channel="ch")
    reg.counter("committed_blocks_total").add(23, channel="ch")
    for lane, slots, pad in (("rows", 9216, 1024), ("generic", 512, 448)):
        reg.counter("provider_lane_slots_total").add(slots, lane=lane,
                                                     device="cuda:0")
        reg.counter("provider_pad_slots_total").add(pad, lane=lane,
                                                    device="cuda:0")
    reg.gauge("provider_dispatch_queue_depth").set(0)
    reg.gauge("pipeline_collect_under_verify_frac").set(0.375, channel="ch")
    reg.counter("validator_device_demotions_total").add(3,
                                                        reason="range_query")
    reg.counter("validator_device_demotions_total").add(
        1, reason="policy_width")
    reg.counter("verify_cache_hits_total").add(900)
    reg.counter("verify_cache_misses_total").add(100)
    reg.gauge("speculative_coverage_frac").set(0.8125, channel="ch")
    reg.counter("gateway_shed_total").add(17, mode="probabilistic")
    reg.gauge("gateway_admission_state").set(2)
    reg.gauge("gateway_orderer_breaker_open").set(1, orderer="o1")
    reg.counter("byzantine_quarantines_total").add(1, reason="equivocation")
    reg.counter("byzantine_offenses_total").add(4, kind="bad_sig")
    for shard in range(4):
        reg.gauge("state_shard_keys").set(2500 + shard, shard=str(shard))
    reg.gauge("state_checkpoint_height").set(20, channel="ch")
    reg.gauge("process_resident_memory_bytes").set(734003200)
    reg.gauge("process_open_fds").set(57)
    reg.counter("fault_injected_total").add(2, kind="drop")
    h = reg.histogram("committer_block_seconds", "commit time")
    for v in (0.01, 0.2, 3.5):
        h.observe(v, channel="ch")
    return reg


@pytest.fixture(scope="module")
def server():
    srv = OperationsServer(metrics=peer_registry()).start()
    try:
        yield "%s:%d" % srv.addr
    finally:
        srv.stop()


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def seeded_exposition(seed: int) -> str:
    """Prometheus text with every escape, comments, blank lines,
    histogram buckets, +Inf/NaN and integer and float values."""
    rng = random.Random(seed)
    alphabet = 'ab\\"\n =,{}z'
    lines = []
    for m in range(12):
        name = f"metric_{m}_total"
        lines += [f"# HELP {name} help text {m}", f"# TYPE {name} counter"]
        for _ in range(rng.randrange(1, 5)):
            labels = {f"l{j}": "".join(rng.choice(alphabet)
                                       for _ in range(rng.randrange(0, 9)))
                      for j in range(rng.randrange(0, 3))}
            body = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
            value = rng.choice([str(rng.randrange(1000)),
                                repr(rng.uniform(-1e6, 1e6)), "+Inf",
                                "1e-09", "0"])
            lines.append(f"{name}{{{body}}} {value}" if body
                         else f"{name} {value}")
        if rng.random() < 0.3:
            lines.append("")
    for le in ("0.005", "0.1", "1.0", "+Inf"):
        lines.append(f'h_seconds_bucket{{le="{le}",ch="c\\"h"}} 3')
    lines += ["h_seconds_sum 1.5", "h_seconds_count 3",
              "weird_gauge NaN"]
    return "\n".join(lines) + "\n"


def _nan_safe(parsed):
    return {k: [(lab, "nan" if v != v else v) for lab, v in series]
            for k, series in parsed.items()}


def test_parse_metrics_of_the_port_server(server):
    text = port_top._get_text(server, "/metrics")
    assert 'device="cuda:0"' in text
    got = port_top.parse_metrics(text)
    assert got == ref_top.parse_metrics(text)
    assert {lab["device"] for lab, _ in got["provider_lane_slots_total"]} \
        == {"cuda:0"}


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_parse_metrics_of_a_seeded_exposition(seed):
    text = seeded_exposition(seed)
    got = port_top.parse_metrics(text)
    assert _nan_safe(got) == _nan_safe(ref_top.parse_metrics(text))
    assert any("\n" in v or '"' in v or "\\" in v
               for series in got.values() for lab, _ in series
               for v in lab.values())


def test_collect_node_on_the_port_server(server):
    port = port_top.collect_node(server)
    ref = ref_top.collect_node(server)
    assert port == ref
    assert port["up"] and port["height"] == 23
    assert set(port["devices"]) == {"cuda:0"}
    down = "127.0.0.1:1"
    assert port_top.collect_node(down) == ref_top.collect_node(down)


def seeded_rows(seed: int, n: int = 9) -> list:
    rng = random.Random(seed)

    def maybe(v):
        return None if rng.random() < 0.25 else v

    rows = []
    for i in range(n):
        addr = f"10.0.{rng.randrange(4)}.{i}:{9443 + i}"
        if rng.random() < 0.15:
            rows.append({"addr": addr, "up": False,
                         "error": "connection refused"})
            continue
        pair = (lambda: maybe((rng.uniform(0, 50), rng.uniform(50, 900))))
        devs = {f"cuda:{d}": maybe(rng.random())
                for d in range(rng.randrange(0, 3))}
        rows.append({
            "addr": addr, "up": True,
            "height": maybe(float(rng.randrange(500))),
            "txs": maybe(float(rng.randrange(10 ** 5))),
            "rate": maybe(rng.uniform(0, 3000)),
            "collect": pair(), "dispatch": pair(), "gate": pair(),
            "commit": pair(), "occupancy": maybe(rng.random()),
            "devices": devs, "overlap": maybe(rng.random()),
            "devval_demotions": maybe({"range_query": float(
                rng.randrange(9)), "policy_width": float(rng.randrange(3))}),
            "devval_policy_width": maybe(float(rng.randrange(3))),
            "vcache": maybe(rng.random()), "spec": maybe(rng.random()),
            "state_shards": maybe(rng.randrange(1, 9)),
            "state_keys": maybe(float(rng.randrange(20000))),
            "ckpt_height": maybe(float(rng.randrange(500))),
            "rss": maybe(float(rng.randrange(10 ** 9))),
            "fds": maybe(float(rng.randrange(300))),
            "queue_depth": float(rng.randrange(40)),
            "breakers_open": float(rng.randrange(3)),
            "shed_total": maybe(float(rng.randrange(3000))),
            "admission_state": maybe(float(rng.randrange(4))),
            "faults_fired": float(rng.randrange(9)),
            "fault_plan": maybe(rng.choice(["geo-wan", "burst"])),
            "byz_quarantines": maybe(float(rng.randrange(3))),
            "byz_reasons": rng.sample(["equivocation", "fork", "bad_sig",
                                       "tampered_attestation"],
                                      rng.randrange(3)),
            "byz_offenses": maybe(float(rng.randrange(7))),
            "byz_score": maybe(rng.randrange(40)),
            "byz_pardons": maybe(rng.randrange(3)),
            "lifecycle": maybe(rng.choice(["serving", "draining",
                                           "drained"])),
            "inc_count": maybe(rng.randrange(4)),
            "inc_last": maybe(rng.choice(["shed_rate", "commit_p99_s"])),
            "inc_partial": rng.random() < 0.3,
            "slo_total": maybe(rng.randrange(6)),
            "slo_alerting": rng.sample(["commit_p99_s", "shed_rate"],
                                       rng.randrange(3)),
            "health": rng.choice(["OK", "DEGRADED"]),
            "spark": maybe("▁▃▅█")})
    return rows


def test_tables_equal():
    for name in ("_COLS", "_WIDTHS", "_ADM_SHORT", "_SORT_KEYS",
                 "_SPARK_BLOCKS", "_UNESCAPE"):
        assert getattr(port_top, name) == getattr(ref_top, name), name


@pytest.mark.parametrize("column", sorted(ref_top._SORT_KEYS))
def test_sort_rows_and_render_for_every_key(column):
    rows = seeded_rows(SEED + len(column))
    got = port_top.sort_rows(rows, column)
    want = ref_top.sort_rows(rows, column)
    assert [r["addr"] for r in got] == [r["addr"] for r in want]
    assert port_top.render(got) == ref_top.render(want)
    assert port_top.render(got, spark_name="process_resident_memory_bytes") \
        == ref_top.render(want, spark_name="process_resident_memory_bytes")


def test_sort_rows_refuses_an_unknown_column():
    for mod in (port_top, ref_top):
        with pytest.raises(SystemExit):
            mod.sort_rows([], "nope")


@pytest.mark.parametrize("fmt", FMTS)
def test_every_cell_formats_alike(fmt):
    rows = [r for seed in range(SEED, SEED + 6)
            for r in seeded_rows(seed) if r["up"]]
    port_fn, ref_fn = getattr(port_top, fmt), getattr(ref_top, fmt)
    rng = random.Random(SEED)
    if fmt in ROW_FMTS:
        args = rows + [{}]
    elif fmt == "_fmt_pair":
        args = [r.get(k) for r in rows for k in ("collect", "gate")] \
            + [(None, 1.0), ()]
    elif fmt == "_fmt_pct":
        args = [r.get(k) for r in rows for k in ("occupancy", "vcache")]
    elif fmt == "_fmt_devices":
        args = [r.get("devices") for r in rows] + [None, {"cuda:0": 0.914}]
    else:
        args = [[rng.uniform(0, 9) for _ in range(rng.randrange(0, 30))]
                for _ in range(20)] + [[1.0, 1.0], [None, 2.0, 3.0]]
    out = [port_fn(a) for a in args]
    assert out == [ref_fn(a) for a in args]
    assert len(set(out)) > 1 or fmt == "_fmt_life"


def _frame(mod, argv, capsys) -> str:
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    # the header starts with the clock (HH:MM:SS)
    head, _, rest = out.partition("  ")
    assert len(head) == 8 and head.count(":") == 2
    return rest


def test_main_once(server, capsys):
    argv = ["--targets", f"{server},127.0.0.1:1", "--once"]
    got = _frame(port_top, argv, capsys)
    assert got == _frame(ref_top, argv, capsys)
    assert "DOWN" in got and server in got
    argv = ["--targets", server, "--once", "--sort", "occ"]
    assert _frame(port_top, argv, capsys) == _frame(ref_top, argv, capsys)


def test_module_imports_neither_jax_nor_the_reference():
    src = importlib.util.find_spec("fabric_tpu_torch.node.top").origin
    text = open(src).read()
    assert "import jax" not in text and "from fabric_tpu." not in text
