"""chip_smoke.py phase 16's seed check (`seed_cut`): the blocks that hold
the 10,000-tx seed must hold every seed txid exactly once, in the order
broadcast, and no other tx, at most SEED_BATCH a block; a block cut short
on BatchTimeout is counted, not refused.  `node_txid` reads an
envelope's txid as the block store indexes it."""
import pytest

import chip_smoke

BATCH = chip_smoke.SEED_BATCH
SEED = [f"tx{i:05d}" for i in range(chip_smoke.NODE_SEED_TXS)]


def cut(sizes, ids=SEED):
    out, at = [], 0
    for n in sizes:
        out.append(list(ids[at:at + n]))
        at += n
    return out


@pytest.mark.parametrize("sizes", [
    [BATCH] * 20,                                   # every cut at the count
    [BATCH] * 16 + [399] + [BATCH] * 3 + [101],     # one timeout cut
    [BATCH] * 16 + [399, 101] + [BATCH] * 3,        # the remainder alone
    [250] * 40,                                     # every cut on the timeout
])
def test_seed_cut_accepts_count_and_timeout_cuts(sizes):
    got, short, faults = chip_smoke.seed_cut(cut(sizes), SEED, BATCH)
    assert faults == []
    assert got == sizes
    assert short == sum(n < BATCH for n in sizes)


def test_seed_cut_refuses_a_block_over_the_batch_or_empty():
    blocks = cut([BATCH + 1] + [BATCH] * 19)
    blocks[-1] = blocks[-1][:-1]
    assert chip_smoke.seed_cut(blocks, SEED, BATCH)[2]
    blocks = cut([BATCH] * 20)
    blocks.insert(5, [])
    assert chip_smoke.seed_cut(blocks, SEED, BATCH)[2]


@pytest.mark.parametrize("fault", ["missing", "twice", "swapped", "foreign",
                                   "extra_block"])
def test_seed_cut_refuses_a_seed_not_ordered_once_in_order(fault):
    blocks = cut([BATCH] * 20)
    if fault == "missing":
        del blocks[7][3]
    elif fault == "twice":
        blocks[19][-1] = blocks[19][-2]
    elif fault == "swapped":
        blocks[3][0], blocks[3][1] = blocks[3][1], blocks[3][0]
    elif fault == "foreign":
        blocks[11][10] = "load-tx"
    else:
        blocks.append(["load-tx"])
    sizes, _short, faults = chip_smoke.seed_cut(blocks, SEED, BATCH)
    assert len(faults) == 1 and "first difference" in faults[0]
    assert sizes == [len(b) for b in blocks]


def test_node_txid_reads_the_envelopes_txid():
    from fabric_tpu_torch.protocol import Envelope
    from fabric_tpu_torch.protocol.build import signed_envelope
    from fabric_tpu_torch.protocol.types import TX_ENDORSER

    class Signer:
        def serialize(self):
            return b"creator"

        def sign(self, msg):
            return b"sig"
    env = signed_envelope(TX_ENDORSER, "ch", {"actions": []}, Signer(),
                          nonce=b"n" * 24, timestamp=1)
    raw = env.serialize()
    assert chip_smoke.node_txid(raw) \
        == Envelope.deserialize(raw).header().channel_header.txid
